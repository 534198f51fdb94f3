#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llm_consensus_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phase kernels   # build + kernel checks only
    python3 chip_smoke.py --phase mixtral   # build + the Mixtral phases only
    python3 chip_smoke.py --phase telemetry # build + the telemetry phase only
    python3 chip_smoke.py --phase modes     # build + the modes phase only
    python3 chip_smoke.py --phase session   # build + the session phase only
    python3 chip_smoke.py --phase serving   # build + the B = 16 kernel rows + serving
    python3 chip_smoke.py --phase recovery  # build + the recovery phase only
    python3 chip_smoke.py --phase kvpool    # build + the KV pool phase only
    python3 chip_smoke.py --phase spec      # build + the dh 64 kernel rows + speculation
    python3 chip_smoke.py --phase gateway   # build + the serve gateway phase only
    python3 chip_smoke.py --phase route     # build + the route phase only
    python3 chip_smoke.py --phase disagg    # build + the disaggregated-serving phase only
    python3 chip_smoke.py --phase distill   # build + three runs + the distill phase only
    python3 chip_smoke.py --phase parallel  # build + the head-slice kernel rows + parallel/
    python3 chip_smoke.py --phase sanitize  # build + the sanitize phase only (child processes)

Phases, in order; any failure exits non-zero before the last line. Every
CLI run of the script asks ``CLI_TOKENS`` (48) tokens a model (the
drafted slice of phase 8g 16), where the phases below say 64:

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
   PyTorch library call timed the same two ways; the llama-3.2-1b shapes
   (dh 64) of flash and the bf16 decode the same way; then the int8 matmuls
   (exactness of the int8 x int8 product, device time of the int8-weight
   matmul against bf16);
4. the small-model check: a narrow model's logits through the kernels
   against the same model through the plain attention op;
5. the slice: one consensus run through the port's CLI (llama-3-8b +
   consensus-1b panel, llama-3-8b judge, random weights from a seed), with
   the kernel launch counters read around it;
6. the chunked path: one Engine.generate on llama-3-8b with a ~1,500-token
   prompt (chunked prefill, then decode at a longer frontier);
7. a torch.profiler window over one llama-3-8b generate (4 tokens, one 4-step chunk): device busy
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
   at B = 4), and short int8-KV and W8A8 shared-prefix runs; then
   ``Engine.generate_batch`` on that llama-3-8b engine: four ragged prompts
   (37, 120, 255 and 350 tokens) left-padded to one bucket, 32 tokens
   each, every row equal to its single-stream generate or a near-tie, no
   flash launch in the batch prefill and one decode launch a layer a step
   (its decode shape is a row of phase 3);
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
   ``torch.cuda.max_memory_allocated`` (the slice's CLI in a fresh process
   with the planes off, its process wall, was cut to fit the parallel
   phase in the time limit);
8b. the consensus modes (``--phase modes``), each through the port's CLI
   over warm shared providers (the slice's panel and judge, bf16, the
   350-token prompt, 24 tokens): ``--rounds 2 --confidence --system-file``
   (7 generates), ``--vote`` (2, no judge engine built), ``--continue``, a
   plain run (the phase's baseline wall), ``--resume`` of that run less one
   panel answer and of a run whose child
   process was killed with SIGKILL after its first panel answer, ``-i``
   over two queries, the config file with an alias, and ``--version``;
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
   (28 x 32 tokens, 4 x 128), shrinks to 8 rows once the short ones retire
   (memory_allocated before and after: 24 rows of 1.07 GB freed), then a
   burst of 12 prompts sharing the slice's prompt regrows it to 16 (the
   state kernel); rows over time, the step wall at 32, 8 and 16 rows, the 4
   moved streams against single-stream; (b) four residents (1,501-token
   prompts, 256 tokens) and a wave of four 1,501-token prompts with
   ``prefill_budget`` 2048, then 0: the residents' longest gap between
   fetches while the wave fills, the wave's time to first token, every
   stream against single-stream; (c) a 2-row pool, two LOW residents (128
   tokens) and a HIGH latecomer (64): a preemption, the resume through
   flash, all three against single-stream; (d) the CLI with 4 x llama-3-8b
   and its judge under ``LLMC_MAX_BATCH=16 --priority low --prefill-budget
   2048``: classes 2 and 1 at the batcher. A batched stream in bf16 must
   equal single-stream or, past a near-tie, keep every token within 0.25 of
   the model's best logit under teacher forcing. Any RuntimeWarning fails
   it. A ``{"serving": ...}`` line;
8e. the recovery phase (``--phase recovery``): (a) a journaled
   ``GPUProvider(batch_streams=2)`` on llama-3-8b bf16 serves three 64-token
   streams (the third queued) through ``crash@chunk=2``: one rebuild, every
   stream whole with its streamed text continuous, the journal empty, the
   rebuilt engine's parameter digest equal to the first one's, flash
   launched in the replay prefill and the decode kernel after it, each
   stream against single-stream by the near-tie rule with its planted-fault
   reading; memory_allocated before the crash, after the rebuild and once
   the dead engine is collected, the rebuild wall and the crash's wall to
   the first replayed token; (d) every WAL file of (a) read back equal to
   its journal entry, and a copy with its last record torn truncated to the
   last good record; (c) a 4-stream pool on (a)'s engine with the integrity
   plane on, clean (equal to a plane-off run exactly) and with
   ``nan_logits@row=1@step=2`` (row 1 fails typed after one chunk, the
   others equal the clean run), and the decode step wall with the sentinel
   and without; (b) consensus-1b under ``wedge@chunk=2@s=30`` and a 2.0 s
   heartbeat: the 48-token answer in under 25 s, the detection latency; (e)
   the batched slice's CLI with ``LLMC_JOURNAL=1 LLMC_FAULTS=crash@chunk=3``
   and ``--events``: exit 0, one restart, ``faults.txt`` and
   ``metrics.json``'s ``faults``. Any RuntimeWarning fails it. A
   ``{"recovery": ...}`` line;
8f. the KV pool phase (``--phase kvpool``) on llama-3-8b bf16: (a) an
   engine with the cross-request paged KV pool (64-token blocks, a 4,096 MB
   arena; ``memory_allocated`` across its construction equal to the arena's
   modeled bytes) takes two prompts sharing a 1,101-token prefix, an exact
   repeat, an unrelated 1,501-token prompt and a late third tail (48 tokens
   each): at least 3 hits, every lease released, every stream against the
   same weights without the pool by the near-tie rule; (f) a
   ``ContinuousBatcher(max_batch=4)`` on that engine takes a lone 1,501-token
   request whose first 23 blocks the pool holds: the radix consult
   establishes them as the shared prefix (a gather) and the decode runs the
   kernel's ``return_state`` form, against the same request without the
   pool; (b) the session phase's 1,749-token follow-up on a pool hit against
   a fresh engine: prefill, gather and publish ms (CUDA events, median of
   5), first-step logits, the hit's peak (one gathered cache); (c) the
   default 256 MB arena (30 blocks) under four distinct 1,501-token prompts:
   evictions; (d) a shared-prefix pair over the int8 cache, pool on and
   off, the int8 decode kernel; (e) ``pool_exhausted`` through the provider
   (the response's ``kv``), ``hbm_squeeze@phase=publish@frac=0`` (the
   ledger's ``hbm`` event) and ``bit_flip@surface=kv`` under the integrity
   plane at ``sample=1.0`` (a corrupt gather becomes a miss), each against a
   clean run; (g) the slice's CLI with ``LLMC_KV_POOL=1 LLMC_KV_POOL_MB=4096
   --rounds 2 --events`` and without the pool: a ``kv`` block for every
   preset, flash on the pool's misses, ``result.json``'s keys unchanged.
   Any RuntimeWarning fails it. A ``{"kvpool": ...}`` line;
8g. the speculation phase (``--phase spec``): llama-3-8b bf16 drafted by
   llama-3.2-1b bf16 (16 layers, dh 64), both at full width and 8,192 slots,
   the slice's prompt: (a) k = 4, adaptive and governor off, 48 tokens:
   flash once a layer on both prompts, the decode kernel in every draft step
   (k + 1 a round, 16 layers), none in a verify, at most one host fetch per
   round group, the tokens against plain decode by the near-tie rule; (b)
   the oracle at forced acceptance 1, 2, 3 and 5 against plain decode,
   tokens/s over the request (one run each, 48 tokens); (c) prompt lookup on
   a judge prompt quoting an answer; (d) the governor on: it locks plain;
   (e) rejection sampling at temperature 0.8 (every probability finite),
   then ``acceptance_collapse@p=1`` greedy; (f) a lookup pool and an oracle
   pool (``max_batch=4``) on 4 random 350-token prompts plus one admitted
   mid-stream, and a compaction with holes on a 1,024-slot engine over the
   same weights (the oracle forced to accept 1 a round); (g) the slice's CLI with ``--draft llama-3-8b=llama-3.2-1b
   --spec-k 4 --events`` (16 tokens a model) and the batched slice's with ``LLMC_MAX_BATCH=4
   --draft lookup --events`` (``metrics.json``'s ``spec`` block,
   consensus-1b undrafted). A RuntimeWarning (a "speculative decoding
   disabled" one among them) fails it. A ``{"spec": ...}`` line;
8h. the gateway phase (``--phase gateway``): ``cli.main(["serve", ...])`` in
   this process on a thread, stopped by its shutdown event, over
   ``gpu:llama-3-8b`` + ``gpu:consensus-1b`` (judge llama-3-8b), bf16, full
   width and context, random weights, ``--max-batch 8 --queue-depth 4
   --max-tokens 48``, the governor's knobs of ``GATEWAY_ENV``, real HTTP on
   127.0.0.1: (a) 8 concurrent distinct ~350-token requests (4 run, 4
   queue), every run directory holding the CLI's result files; (a), (b), (d)
   and (f) ask 16 tokens a request (the server's 48 in (c) and (e)); (b) 4
   identical requests (one run, 3 coalesced), a fifth a cache hit, then 4
   questions behind one shared preamble (the ``return_state`` launches); (c)
   one SSE request (chunks of both panel models and the judge, then
   ``done``); (d) 12 LOW requests with a HIGH one inside the burst: some
   shed with ``Retry-After`` in [1.5, 3) s, the ladder past ``ok``, HIGH
   answered; (e) consensus-1b swapped through ``POST /v1/swap`` to an HF
   checkpoint of seed + 1 weights while a request decodes (that stream on
   v0, the next on v1 against a fresh engine, then a rollback to v0, each
   by the near-tie rule; prep, vacate and memory recorded); the TTFT
   count equals the requests answered; (f) a drain with 2 requests in
   flight (exit 0, runs flushed), then ``python -m llm_consensus_tpu_torch
   serve`` in a child process drained by SIGTERM. Every request asks 16
   tokens but (e)'s in-flight one (48). Flash and the bf16 decode kernel
   must launch through the served requests: the launches of (e)'s
   reference runs are counted apart and left out. A ``{"gateway": ...}``
   line (latency median and maximum by request kind);
8i. the route phase (``--phase route``): two replicas in this process, each a
   gateway over its own ``GPUProvider`` (llama-3-8b + consensus-1b, judge
   llama-3-8b, bf16, full width, random weights from the seed,
   ``LLMC_MAX_SEQ=2048``, 4 batcher rows, a journal each), one router from
   ``build_router`` on 127.0.0.1: (a) 4 requests homed 2 and 2 by the ring;
   (b) 3 identical ones, one run on their home and 2 coalesced; (c) an SSE
   request on an idle fleet whose home the router loses at frame 2
   (``replica_down``): the client's text equals an undisturbed run on the
   other replica (or every differing stream is within the near-tie rule),
   one ``done``; (d) a one-model 48-token SSE request migrated by ``POST
   /v1/retire`` mid-decode: one resident, migrated, the record carries
   tokens, the destination resumes through ``replay_ids`` with flash over
   prompt + tokens, the text equals its reference; (e) the router's
   ``/metricsz`` is the bucket-wise merge of the replicas', ``/statsz`` holds
   the failovers and migrations, one trace id on the router's span, on both
   replicas' ``engine_stream`` spans for (c) and in the destination's
   journal for (d); (f) no replica placeable: a long-deadline request spills
   to the local SSE mock (``degraded: remote``), a 5 s one gets 503; (g)
   ``main(["route", ...])`` answers one request over one replica and exits 0
   on shutdown. Flash and the bf16 decode kernel must launch through the
   routed traffic; (c)'s and (d)'s references are counted apart. A
   ``{"route": ...}`` line;
8j. disaggregated prefill -> decode (``--phase disagg``): ``serve --disagg``
   in process over llama-3-8b + consensus-1b (judge llama-3-8b, bf16, full
   width, 8 batcher rows, the KV pool at 2,048 MB a preset, the governor and
   the result cache off); both roles share the card, the prefill worker on
   a CUDA stream of its own over the decode engine's weight tree: (a) 4
   distinct ~350-token requests with disagg off, then on: handoffs complete
   with no fallback, ``handoff_blocks`` > 0, the prefill role's flash
   launches (the handoff threads') counted apart, the decode kernel
   launched, answers equal to disagg off or within the near-tie rule, no
   second weight tree in memory; (c) ``prefill_worker_crash@wave=1``: the
   answer unchanged, the fallback counted; (d) consensus-1b swapped to seed
   + 1 weights, then a ~700-token request whose stream equals a fresh engine
   on them (near-tie rule); (b) on one provider, four 1,501-token residents
   and a 4 x 1,501-token wave sharing a 1,472-token preamble, disagg off then
   on: the residents' longest fetch gap while the wave fills, the wave's
   time to first token, every stream on against off. A ``{"disagg": ...}``
   line;
8k. distillation (``--phase distill``; alone it first makes three one-shot
   runs): ``distill --student consensus-1b --steps 8 --holdout 0.5`` over the runs the
   disagg phase auto-saved, at full width in float32 (teacher = the student
   preset, as in JAX): holdout loss before and after, each step's wall,
   peak memory; then ``serve`` over consensus-1b with the integrity plane
   on swaps the HF safetensors checkpoint in through ``POST /v1/swap
   {"out_dir"}`` (digest checked) and a request's stream equals a fresh
   engine loaded from the checkpoint (near-tie rule). A ``{"distill": ...}``
   line;
8l. ``parallel/`` (``--phase parallel``, after the head-slice kernel rows of
   phase 3) on mesh positions backed by the one card: (a) llama-3-8b bf16 on
   a tp 2 mesh against tp 1 (64 greedy tokens, launches by shard at Hq 16 /
   Hkv 4), (b) an sp 2 ring prefill of 1,024 tokens against the chunked
   path, (c) the slice's CLI over a provider of 4 positions, (d) two
   controller processes over gloo with equal merged results, (e) a
   one-process gloo + NCCL group's training step against the step without
   one; then serving over (a)'s tp 2 engine: (f) a ``ContinuousBatcher``
   of 4 rows (a shared-prefix wave, then 4 unrelated prompts) against the
   same waves on tp 1, each shard's flash, decode and state launches at its
   head slice, (g) a KV-pool hit and its miss, (h) a handoff from the tp 1
   engine into the tp 2 pool (bitwise), (i) prompt lookup on a judge
   prompt, and (j) a weight swap of a tp 2 consensus-1b against a fresh
   engine on the new weights. A ``{"parallel": ...}`` line;
8m. the runtime sanitizer (``--phase sanitize``), in child processes of
   this script (the sanitizer resolves ``LLMC_SANITIZE`` once per process):
   (a) with ``LLMC_SANITIZE=1``, the CLI over a 4 x consensus-1b panel and
   a consensus-1b judge, bf16, 24 tokens, under ``LLMC_MAX_BATCH=4
   LLMC_KV_POOL=1 LLMC_JOURNAL=1 LLMC_INTEGRITY=1 LLMC_FAULTS=crash@chunk=3``
   (one crash, one restart, the replay); (b) with it, ``serve --disagg``
   over consensus-1b and four ~700-token requests, each handed off; (c) (a)
   again without it. No lock-order cycle and no off-lock access in (a) or
   (b), every kernel of (a) launched, every (b) request answered, and (a)'s
   streams equal to (c)'s or near-ties. A ``{"sanitize": ...}`` line;
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
17. a ``{"phase_walls_s": ...}`` line (each phase's wall, as ``main`` logged
    it when the phase ended), a ``{"kernels": [...]}`` line (the phase 3
    records, the llama-3.2-1b dh-64 rows among them), the card line, then
    the ``{"ok": true, ...}`` line.

Each path's launch counts are set to 0 just before it runs and read just
after; a kernel of the path that never launched fails the run.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import faulthandler
import gc
import io
import json
import os
import shutil
import statistics
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


# Tokens a model of every CLI run of the script asks (cut from 64 to fit the
# gateway phase in the time limit; 48 keeps the rate clock's 3 chunks).
CLI_TOKENS = "48"


def run_slice(torch, counters: dict, env: dict, label: str,
              models: str = "gpu:llama-3-8b,gpu:consensus-1b", events: bool = False,
              extra: tuple = (), data_dir: str = "", prompt: str = PROMPT,
              timing: bool = True, n_models: int = 0, judge: str = "gpu:llama-3-8b",
              max_tokens: str = CLI_TOKENS) -> dict:
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
            "--models", models, "--judge", judge, "--max-tokens", max_tokens,
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


# Decode steps of the int8 and Mixtral profile windows: the profiler's event
# processing, not the generate, takes most of a window's wall (~70 s of the
# bf16 window's 81 s at 48 tokens on an H100 80GB HBM3 at 700 W), and it
# grows with the launches recorded. Such a window decodes them in one chunk
# of as many steps, which the main path never runs: its busy share is a
# 4-step chunk's. The bf16 window, whose busy share reads the main path's
# host overhead, runs the engine's own 16-step chunk.
PROFILE_TOKENS = 4


def profile_decode(torch, engine, label: str = "profile", run=None, counter=None,
                   export: str = None, stats: dict = None, steps: int = PROFILE_TOKENS) -> dict:
    """Where the time goes: torch.profiler over ``run()`` (by default one
    generate of the 350-token prompt and ``steps`` tokens, in one chunk of
    ``steps`` steps), run once before to
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
        sp = SamplingParams(max_new_tokens=steps, ignore_eos=True)

        def run():
            interval, engine.stream_interval = engine.stream_interval, steps
            try:
                engine.generate_ids(ids, sp)
            finally:
                engine.stream_interval = interval

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
    # kernels it launched. The averages are built once (each build walks
    # every recorded event).
    averages = prof.key_averages()
    events = [e for e in averages
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
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
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


# Tokens a stream of the batched engine's waves.
BATCHED_TOKENS = 48


def run_batched_engine(torch, fa, da, engine, state_recs: dict) -> None:
    """The batcher on llama-3-8b, driven directly."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    prompts = [PROMPT + sfx for sfx in SUFFIXES]
    ids = [tok.encode(p) for p in prompts]
    p = len(tok.encode(PROMPT))
    check_batch_logits(torch, engine, ids, p)
    s = SamplingParams(max_new_tokens=BATCHED_TOKENS, ignore_eos=True)

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
    log(f"batched engine, shared prefix: {len(results)} streams x {BATCHED_TOKENS} tokens "
        f"in {wall:.2f} s, "
        f"stats {snap}, pool decode {snap['decode_tokens'] / snap['decode_s']:.1f} tokens/s; "
        f"launches state {state_n}, bf16 decode {bf16_n} (state ones included), flash "
        f"{flash_n}; leading tokens equal to the single-stream engine's {agree} "
        f"(of {BATCHED_TOKENS})")
    # Every decode step ran with the prefix: no bf16 launch without state.
    if (state_n <= 0 or bf16_n != state_n or snap["establish_tokens"] < 192
            or any(len(r.token_ids) != BATCHED_TOKENS for r in results)):
        raise AssertionError(f"batched engine shared wave: {snap}, state {state_n}, "
                             f"bf16 {bf16_n}")

    # Where a shared-prefix wave's time goes (4 streams x PROFILE_TOKENS: the
    # profiler's event processing, not the wave, fills a longer window).
    sp = SamplingParams(max_new_tokens=PROFILE_TOKENS, ignore_eos=True)
    b = ContinuousBatcher(engine, max_batch=4)
    try:
        profile_decode(torch, engine, "profile batched shared prefix", run=lambda: [
            f.result(timeout=600) for f in [b.submit(pr, sp) for pr in prompts]])
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
    sp = SamplingParams(max_new_tokens=16, ignore_eos=True)
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


def measure_overhead(torch, engine) -> None:
    """The same llama-3-8b generate with every plane bound and with none,
    in turns (off, on; off, on, on, off until PR 13): both decode rates, the
    host time inside
    telemetry code per decode chunk, and the synchronizations per chunk,
    which must not differ."""
    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.engine import SamplingParams

    planes = (engine._obs, engine._attrib, engine._roofline)
    if any(p is None for p in planes):
        raise AssertionError(f"overhead: the engine bound {planes}")
    host_ns = [0]
    depth = threading.local()
    hooks = [(obs.Recorder, "complete"), (obs.Recorder, "count"),
             (obs.attrib.ChipTimeLedger, "observe_device"),
             (obs.attrib.ChipTimeLedger, "token_event"),
             (obs.roofline.RooflineLedger, "dispatch"), (obs.live.LiveMetrics, "observe"),
             (obs.attrib.DeviceWall, "__init__"), (obs.attrib.DeviceWall, "stop"),
             (obs.attrib.DeviceWall, "seconds")]

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
    sp = SamplingParams(max_new_tokens=48, ignore_eos=True)
    engine.generate_ids(ids, sp)  # warm: every key of this shape counted already
    arms = {"off": [], "on": []}
    try:
        for cls, name, fn in originals:
            setattr(cls, name, timed(fn))
        torch.cuda.synchronize = counted(sync_orig[0])
        torch.cuda.Event.synchronize = counted(sync_orig[1])
        engine._decode_chunk = chunk
        for arm in ("off", "on"):
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
    log(f"telemetry phase: {time.monotonic() - t_phase:.1f} s")


# -- the modes phase: the CLI's consensus modes at the slice's width ----------

MODES_PANEL = "gpu:llama-3-8b,gpu:consensus-1b"
MODES_JUDGE = "gpu:llama-3-8b"
# 24: the modes' checks count generates, launches and
# prompts, and read no decode rate (the disagg and distill phases' cut).
MODES_TOKENS = "24"
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
            "--judge", MODES_JUDGE, "--max-tokens", MODES_TOKENS, "--data-dir", data_dir,
            PROMPT]
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
    prompt, 48 new tokens), the crash case in a child process. Returns the
    rows of the ``{"modes": ...}`` line."""
    from llm_consensus_tpu_torch.cli.main import install_planes, load_panel_journal
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    t_phase = time.monotonic()
    gens = GenerateLog()
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "generates": gens}
    env = {"LLMC_CONFIG": "0"}
    slice_kw = {"models": MODES_PANEL, "judge": MODES_JUDGE, "max_tokens": MODES_TOKENS}
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
                       max_tokens=MODES_TOKENS,
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

        # 5. -i: a query, drop consensus-1b, a second query over the first's
        # history, /reset, /exit (three queries until the route phase).
        session = os.path.join(tmp, "interactive")
        stdin = "\n".join([PROMPT, f"/models -gpu:{second}", FOLLOW_UPS[0], "/reset",
                           "/exit"]) + "\n"
        run = cli_call(torch, counters, env,
                       ["--models", MODES_PANEL, "--judge", MODES_JUDGE, "--max-tokens",
                        MODES_TOKENS, "--data-dir", session, "-i"], stdin=stdin)
        runs = saved_runs(session) if os.path.isdir(session) else []
        docs = [r.get("result.json", {}) for r in runs]
        shape = [(len(d.get("history", [])), len(d.get("responses", []))) for d in docs]
        log(f"  interactive: exit {run['rc']}, runs (history, responses) {shape}; stderr "
            f"{run['err'].strip()!r}")
        if (run["rc"] != 0 or "error:" in run["err"] or shape != [(0, 2), (1, 1)]
                or docs[1]["consensus"] != docs[1]["responses"][0]["content"]):
            raise AssertionError(f"interactive: exit {run['rc']}, runs {shape}: "
                                 f"{run['err'][-2000:]}")
        rows["interactive"] = check_mode("interactive", run, gens, docs, 4, min_flash=2)

        # 6. The config file through LLMC_CONFIG: an alias and rounds 2.
        config = os.path.join(tmp, "llm-consensus.json")
        with open(config, "w", encoding="utf-8") as f:
            json.dump({"aliases": {"@panel": MODES_PANEL}, "rounds": 2}, f)
        sl = run_slice(torch, counters, {"LLMC_CONFIG": config}, "modes: config file",
                       judge=MODES_JUDGE, models="@panel", n_models=2, data_dir=os.path.join(tmp, "config"),
                       timing=False, max_tokens=MODES_TOKENS)
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
                 steps: int = 8, sentinel: bool = False) -> list:
    """Wall per decode step (host launches + device) of ``engine``'s decode
    chunk at ``rows`` rows and the attention width of ``frontier``: after a
    warm 16-step chunk, ``windows`` windows of ``steps`` steps, each ending
    in a synchronize; the per-step wall of each window. ``sentinel``: the
    chunks carry the finite-logit sentinel (the integrity plane on)."""
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
        res = engine._decode_chunk(token, start, cache, 16, None, (0.0, None, None), width,
                                   sentinel=sentinel, **kw)
        token, start = res[0], res[2]
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = engine._decode_chunk(token, start, cache, steps, None, (0.0, None, None),
                                       width, sentinel=sentinel, **kw)
            token, start = res[0], res[2]
            torch.cuda.synchronize()
            out.append((time.monotonic() - t0) * 1e3 / steps)
    del cache
    return out


# (a)'s four long streams: they outlive the short ones by 96 tokens, 6 chunks
# (the pool shrinks 3 dispatches after the shorts retire).
SERVING_LONG_TOKENS = 128


def serving_rows(torch, fa, engine, seed: int) -> dict:
    """(a) Row bucketing: a 32-row pool takes 32 random 350-token prompts
    (28 x 32 tokens, 4 x 128), shrinks to 8 rows once the short ones
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
    long = SamplingParams(max_new_tokens=SERVING_LONG_TOKENS, ignore_eos=True)
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
    if any(len(r.token_ids) != (SERVING_LONG_TOKENS if i >= 28 else 32)
           for i, r in enumerate(first)) or any(
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
    other 1,501-token prompts (32 tokens) arrives. Budget 2048, then 0 (two
    more runs, 0 and 2048, until PR 13): the residents' longest gap between
    fetches while the wave fills and the wave's time to its first token;
    every stream against single-stream."""
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    residents = [random_ids(torch, seed + 200 + i, 1500, tok.bos_id) for i in range(4)]
    wave = [random_ids(torch, seed + 300 + i, 1500, tok.bos_id) for i in range(4)]
    s_res = SamplingParams(max_new_tokens=128, ignore_eos=True)
    s_wave = SamplingParams(max_new_tokens=32, ignore_eos=True)
    runs = []
    for budget in (2048, 0):
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
    log(f"  streams equal to the first run's in each of the {len(runs)} runs (4 residents, 4 "
        f"wave): {same}")
    if same[:4] != [len(runs)] * 4:
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

    def submit(b, prompt, sampling, ctx=None, on_text=None, *, priority=1, **kw):
        with lock:
            classes.append((priority, "You are a synthesis judge" in prompt))
        return real(b, prompt, sampling, ctx, on_text, priority=priority, **kw)

    # LLMC_PREFILL_BUDGET is set to 0 for the call and restored after it:
    # the flag sets it inside the call (flag and knob are one setting).
    env = {"LLMC_MAX_BATCH": "16", "LLMC_PREFILL_BUDGET": "0"}
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    argv = ["--models", ",".join([f"gpu:{SERVING_MODEL}"] * 4), "--judge",
            f"gpu:{SERVING_MODEL}", "--max-tokens", CLI_TOKENS, "--priority", "low",
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


# -- phase 8e: crash recovery, the wedge watchdog, the sentinel, the WAL ---------

RECOVERY_MODEL = "llama-3-8b"
WEDGE_MODEL = "consensus-1b"
# Three prompts of the slice's family that share no pool prefix (each
# admission and each replay prefills its whole prompt through flash).
RECOVERY_PROMPTS = [f"Question {i + 1} of three. " + PROMPT for i in range(3)]


def marked_plan(torch, spec: str, seed: int, marks: dict, counters: tuple = ()):
    """A fault plan that also records, at each fault's first fire, the host
    clock (``marks[kind]``), ``memory_allocated`` (``marks[kind + "_mem"]``)
    and the given launch counters (``marks[kind + "_launches"]``)."""
    from llm_consensus_tpu_torch.faults import FaultPlan

    class Marked(FaultPlan):
        def fire(self, site, **attrs):
            hit = super().fire(site, **attrs)
            if hit is not None and hit.kind not in marks:
                marks[hit.kind + "_mem"] = torch.cuda.memory_allocated()
                marks[hit.kind + "_launches"] = [c.count for c in counters]
                marks[hit.kind] = time.monotonic()
            return hit

    return Marked(spec, seed=seed)


def kept_journal(path):
    """A StreamJournal (mirrored to ``path`` when given) that keeps every
    entry it opened."""
    from llm_consensus_tpu_torch.recovery import StreamJournal

    class Kept(StreamJournal):
        def __init__(self):
            super().__init__(path=path)
            self.entries = []

        def record(self, *a, **k):
            entry = super().record(*a, **k)
            self.entries.append(entry)
            return entry

    return Kept()


@contextlib.contextmanager
def first_emits(stamps: dict, counters: tuple = ()):
    """Record, per batcher, the host clock and the launch counters at its
    first emitted token (``stamps[id(batcher)]``)."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher as CB

    real = CB._emit

    def emit(b, slot, tok, eos):
        if id(b) not in stamps:
            stamps[id(b)] = (time.monotonic(), [c.count for c in counters])
        return real(b, slot, tok, eos)

    CB._emit = emit
    try:
        yield
    finally:
        CB._emit = real


def query_all(provider, model: str, prompts: list, max_tokens: int) -> tuple:
    """Each prompt through ``provider.query_stream`` on its own thread, at
    once; returns the responses and each stream's streamed chunks."""
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.utils.context import Context

    results, errors = [None] * len(prompts), [None] * len(prompts)
    streamed = [[] for _ in prompts]

    def fire(i):
        try:
            results[i] = provider.query_stream(
                Context.background(),
                Request(model=model, prompt=prompts[i], max_tokens=max_tokens),
                streamed[i].append)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors[i] = exc

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(e is not None for e in errors) or any(r is None for r in results):
        raise AssertionError(f"a supervised stream failed: {errors}")
    return results, streamed


def final_streams(journal, prompts_ids: list) -> list:
    """The tokens of each stream's last journal entry (finish ``length``),
    in the order of ``prompts_ids``."""
    done = [e for e in journal.entries if e.finish == "length"]
    return [next(e for e in done if e.prompt_ids == ids).tokens() for ids in prompts_ids]


def recovery_crash(torch, fa, da, tmp: str) -> tuple:
    """(a) Crash replay at full width: llama-3-8b bf16 (random weights from
    seed 0) under ``GPUProvider(batch_streams=2, journal=...)``, three
    streams of 64 tokens (the third queued), ``crash@chunk=2`` seed 7.
    Returns the row and the rebuilt engine (for (c)) with the journal (for
    (d))."""
    from llm_consensus_tpu_torch import faults, integrity
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    model = f"gpu:{RECOVERY_MODEL}"
    counters = (fa.LAUNCHES, da.LAUNCHES)
    marks, stamps = {}, {}
    faults.install(marked_plan(torch, "crash@chunk=2", 7, marks, counters))
    journal = kept_journal(os.path.join(tmp, "wal"))
    provider = GPUProvider(batch_streams=2, journal=journal, ignore_eos=True)
    t0 = time.monotonic()
    engine = provider._engine_for(model)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    digest0 = integrity.digest_tree(engine.params)
    digest_s = time.monotonic() - t0
    prompts_ids = [engine._budget_prompt(engine.tokenizer.encode(p), 64)[0]
                   for p in RECOVERY_PROMPTS]
    pool_gb = (2 * 2 * engine.cfg.n_layers * engine.max_seq * engine.cfg.n_kv_heads
               * engine.cfg.head_dim * engine.dtype.itemsize) / 1e9
    del engine
    real_recover = provider._recover_batcher

    def recover(preset, failed):
        t = time.monotonic()
        marks.setdefault("recover", t)
        batcher = real_recover(preset, failed)
        torch.cuda.synchronize()
        if "rebuilt" not in marks:
            marks["rebuilt"] = time.monotonic()
            marks["rebuild_s"] = marks["rebuilt"] - t
            marks["rebuilt_mem"] = torch.cuda.memory_allocated()
        return batcher

    provider._recover_batcher = recover
    t0 = time.monotonic()
    with first_emits(stamps, counters):
        results, streamed = query_all(provider, model, RECOVERY_PROMPTS, 64)
    wall = time.monotonic() - t0
    launches_end = [c.count for c in counters]
    # Nothing references the dead engine and pool any more: collected, the
    # rebuilt engine and pool remain.
    release_memory(torch)
    collected_gb = torch.cuda.memory_allocated() / 1e9
    stats = provider.recovery_stats()
    engine = provider.engines()[RECOVERY_MODEL]
    engine._faults = None  # the plan it bound when rebuilt is spent
    new_id = id(provider._batchers[RECOVERY_MODEL])
    answers = [(r.tokens, r.content) for r in results]
    provider._recover_batcher = real_recover
    provider.release()
    del provider, results
    faults.reset()
    release_memory(torch)
    t_first, launches_first = stamps[new_id]
    flash_replay = launches_first[0] - marks["crash_launches"][0]
    decode_after = launches_end[1] - launches_first[1]
    digest1 = integrity.digest_tree(engine.params)
    before_gb, rebuilt_gb = marks["crash_mem"] / 1e9, marks["rebuilt_mem"] / 1e9
    row = {"build_s": build_s, "digest_s": digest_s, "wall_s": wall,
           "rebuild_s": marks["rebuild_s"], "crash_to_first_replayed_s": t_first - marks["crash"],
           "memory_gb": {"before_crash": before_gb, "after_rebuild": rebuilt_gb,
                         "dead_engine_collected": collected_gb,
                         "freed": rebuilt_gb - collected_gb, "pool": pool_gb},
           "launches_replay": {"flash_attention": flash_replay, "decode_attention": decode_after},
           "stats": stats, "digest": [digest0, digest1]}
    log(f"recovery (a): {RECOVERY_MODEL} built in {build_s:.2f} s (digest {digest_s:.2f} s); "
        f"3 streams x 64 tokens on 2 slots through crash@chunk=2 in {wall:.2f} s; rebuild "
        f"wall {marks['rebuild_s']:.3f} s; crash to the first replayed token "
        f"{row['crash_to_first_replayed_s']:.3f} s; memory_allocated before the crash "
        f"{before_gb:.3f} GB, after the rebuild {rebuilt_gb:.3f} GB, dead engine collected "
        f"{collected_gb:.3f} GB (freed {rebuilt_gb - collected_gb:.3f} GB; the pool "
        f"{pool_gb:.3f} GB); launches: flash {flash_replay} from the crash to the first "
        f"replayed token, decode {decode_after} after it; stats {stats}; params digest "
        f"{digest0} -> {digest1}")
    if (stats["restarts"] != 1 or stats["replayed_streams"] < 1 or stats["journal_depth"] != 0
            or digest1 != digest0):
        raise AssertionError(f"recovery (a): stats {stats}, digests {digest0} {digest1}")
    if flash_replay < engine.cfg.n_layers or decode_after <= 0:
        raise AssertionError(f"recovery (a): replay launches {row['launches_replay']}")
    if collected_gb > before_gb + pool_gb:
        raise AssertionError(f"recovery (a): {collected_gb:.3f} GB still allocated after the "
                             f"dead engine was collected ({before_gb:.3f} before the crash)")
    got = final_streams(journal, prompts_ids)
    for i, ((n, content), chunks, toks) in enumerate(zip(answers, streamed, got)):
        # Continuity: the streamed chunks concatenate exactly to the content.
        if n != 64 or len(toks) != 64 or "".join(chunks) != content:
            raise AssertionError(f"recovery (a): stream {i}: {n} tokens ({len(toks)} "
                                 f"journaled), streamed text equal "
                                 f"{''.join(chunks) == content}")
    s = SamplingParams(max_new_tokens=64, ignore_eos=True)
    row["greedy"] = [greedy_check(torch, engine, f"replayed stream {i}", ids, toks,
                                  engine.generate_ids(ids, s).token_ids)
                     for i, (ids, toks) in enumerate(zip(prompts_ids, got))]
    row["faults"] = fault_readings(torch, engine, "recovery (a)", prompts_ids, got)
    engine.drop_prefix()
    return row, engine, journal


def recovery_wedge(torch) -> dict:
    """(b) Wedge: consensus-1b, ``wedge@chunk=2@s=30``, heartbeat 2.0 s,
    one stream of 48 tokens: it finishes in under 25 s with the
    single-stream answer, at least one restart; the detection latency is
    the wedge's fire to the watchdog's abandonment."""
    from llm_consensus_tpu_torch import faults
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher as CB
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.recovery import EngineWedged
    from llm_consensus_tpu_torch.utils.context import Context

    model = f"gpu:{WEDGE_MODEL}"
    marks: dict = {}
    faults.install(marked_plan(torch, "wedge@chunk=2@s=30", 7, marks))
    journal = kept_journal(None)
    provider = GPUProvider(batch_streams=2, journal=journal, ignore_eos=True,
                           engine_heartbeat_s=2.0)
    provider._engine_for(model)  # built before the clock starts
    real_abandon = CB.abandon

    def abandon(b, exc):
        if isinstance(exc, EngineWedged):
            marks.setdefault("abandon", time.monotonic())
        return real_abandon(b, exc)

    CB.abandon = abandon
    try:
        t0 = time.monotonic()
        r = provider.query(Context.background(), Request(model=model, prompt=PROMPT,
                                                         max_tokens=48))
        wall = time.monotonic() - t0
    finally:
        CB.abandon = real_abandon
    stats = provider.recovery_stats()
    engine = provider.engines()[WEDGE_MODEL]
    provider.release()
    faults.reset()
    (ids,) = {tuple(e.prompt_ids) for e in journal.entries}
    (got,) = final_streams(journal, [list(ids)])
    detect = marks["abandon"] - marks["wedge"]
    log(f"recovery (b): {WEDGE_MODEL}, wedge@chunk=2@s=30 under a 2.0 s heartbeat: the "
        f"48-token answer in {wall:.2f} s, detection latency {detect:.3f} s (wedge to "
        f"abandonment), stats {stats}")
    if wall >= 25.0 or stats["restarts"] < 1 or r.tokens != 48 or len(got) != 48:
        raise AssertionError(f"recovery (b): wall {wall:.2f} s, stats {stats}, {r.tokens} tokens")
    check = greedy_check(torch, engine, "wedged stream", list(ids), got,
                         engine.generate_ids(list(ids), SamplingParams(
                             max_new_tokens=48, ignore_eos=True)).token_ids)
    del engine
    release_memory(torch)
    # The wedged scheduler thread still sleeps (30 s from the wedge) and holds
    # its engine until it wakes; it then dispatches nothing more.
    return {"wall_s": wall, "detect_s": detect, "stats": stats, "greedy": check}


def recovery_sentinel(torch, engine, seed: int) -> dict:
    """(c) The sentinel on a 4-stream llama-3-8b pool: clean with the plane
    on, the same with the plane off (equal exactly), and with
    ``nan_logits@row=1@step=2`` (row 1 fails with IntegrityError, its entry
    holding only the tokens emitted before the poisoned chunk; rows 0, 2
    and 3 equal the clean run); then the decode step wall at 4 rows with
    the sentinel and without (median and range of 5 windows of 8 steps)."""
    from llm_consensus_tpu_torch import faults, integrity
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    prompts = [random_ids(torch, seed + 500 + i, 349, tok.bos_id) for i in range(4)]
    s = SamplingParams(max_new_tokens=48, ignore_eos=True)

    def run(plane, plan, journal=None):
        integrity.install(plane)
        engine._faults = plan  # the plan the batcher reads, bound per run
        b = ContinuousBatcher(engine, max_batch=4, journal=journal)
        try:
            futs = [b.submit_ids(ids, s) for ids in prompts]
            out = []
            for f in futs:
                try:
                    out.append(f.result(timeout=600).token_ids)
                except integrity.IntegrityError as exc:
                    out.append(exc)
            return out
        finally:
            b.close()
            engine._faults = None
            integrity.reset()

    plane = integrity.IntegrityPlane()
    clean = run(plane, None)
    off = run(None, None)
    journal = kept_journal(None)
    poisoned = run(plane, faults.FaultPlan("nan_logits@row=1@step=2", seed=5), journal)
    stats = plane.stats()
    kept = journal.entries[1].tokens()
    log(f"recovery (c): plane-on clean run equal to plane-off {clean == off}; poisoned row 1: "
        f"{type(poisoned[1]).__name__} ({poisoned[1]}), {len(kept)} tokens journaled (the "
        f"first token and one 16-step chunk), neighbours equal to the clean run "
        f"{[poisoned[i] == clean[i] for i in (0, 2, 3)]}; plane {stats}")
    if clean != off or not all(len(t) == 48 for t in clean):
        raise AssertionError("recovery (c): the plane changed a clean run's tokens")
    if (not isinstance(poisoned[1], integrity.IntegrityError) or poisoned[1].surface != "logits"
            or journal.entries[1].finish != "integrity" or kept != clean[1][:len(kept)]
            or len(kept) != 1 + engine.stream_interval
            or [poisoned[i] for i in (0, 2, 3)] != [clean[i] for i in (0, 2, 3)]
            or stats["failures"] != {"logits": 1}):
        raise AssertionError(f"recovery (c): poisoned run {poisoned}, stats {stats}")
    # Alternating turns of 5 windows of 8 steps, off first: host-paced walls
    # drift between turns, so each turn is printed beside the pooled median.
    turns = [("off" if i % 2 == 0 else "on",
              step_wall_ms(torch, engine, 4, 512, sentinel=i % 2 == 1)) for i in range(4)]
    walls = {k: [w for label, ws in turns if label == k for w in ws] for k in ("off", "on")}
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    log("  decode step wall at 4 rows, frontier 512 (ms per step, turns of 5 windows of 8 "
        "steps, median [min-max]): "
        + ", ".join(f"{label} {sorted(ws)[2]:.3f} [{min(ws):.3f}-{max(ws):.3f}]"
                    for label, ws in turns)
        + "; pooled: " + ", ".join(f"sentinel {k} {med[k]:.3f}" for k in ("off", "on"))
        + f"; on / off {med['on'] / med['off']:.4f}")
    return {"equal_plane_off": clean == off, "kept": len(kept), "stats": stats,
            "step_ms_turns": turns, "step_ms_median": med}


def recovery_wal(journal, tmp: str) -> dict:
    """(d) Every WAL file (a) wrote reads back through ``read_wal`` as its
    journal entry's prompt, tokens and finish; a copy of one with its last
    record torn truncates to the last good record."""
    from llm_consensus_tpu_torch.recovery import read_wal

    wal_dir = os.path.join(tmp, "wal")
    files = sorted(os.listdir(wal_dir))
    for e in journal.entries:
        path = os.path.join(wal_dir, f"{os.getpid()}-{e.sid}.wal")
        doc = read_wal(path, repair=False)
        if (doc is None or doc["truncated"] or doc["header"]["prompt_ids"] != e.prompt_ids
                or doc["tokens"] != e.tokens() or doc["finish"] != e.finish):
            raise AssertionError(f"recovery (d): {path} reads back as {doc}")
    last = next(e for e in journal.entries if e.finish == "length")
    with open(os.path.join(wal_dir, f"{os.getpid()}-{last.sid}.wal"), "rb") as f:
        blob = f.read()
    start = blob.rstrip(b"\n").rfind(b"\n") + 1
    torn_path = os.path.join(tmp, "torn.wal")
    with open(torn_path, "wb") as f:
        f.write(blob[:start + (len(blob) - start) // 2])
    torn = read_wal(torn_path)
    again = read_wal(torn_path)
    log(f"recovery (d): {len(files)} WAL files ({len(journal.entries)} entries) read back "
        f"equal; a torn last record read as {torn['records']} records (of "
        f"{blob.count(b'\n')}), truncated {torn['truncated']}, finish {torn['finish']}, the "
        f"repaired file clean {not again['truncated']}")
    if (len(files) != len(journal.entries) or not torn["truncated"] or torn["finish"] is not None
            or torn["tokens"] != last.tokens() or torn["records"] != blob.count(b"\n") - 1
            or again["truncated"] or again["tokens"] != last.tokens()):
        raise AssertionError(f"recovery (d): torn read {torn}, again {again}")
    return {"files": len(files), "torn_records": torn["records"]}


def recovery_cli(torch, fa, da, tmp: str) -> dict:
    """(e) The batched slice through the CLI with ``LLMC_JOURNAL=1
    LLMC_FAULTS=crash@chunk=3`` and ``--events``, auto-saved: exit 0, every
    answer and a consensus, one restart, ``faults.txt`` in the run
    directory and ``metrics.json``'s ``faults`` listing the crash."""
    from llm_consensus_tpu_torch import faults
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    fresh_planes()
    faults.reset()
    data = os.path.join(tmp, "data")
    env = {"LLMC_MAX_BATCH": "4", "LLMC_PREFILL_BUDGET": "0", "LLMC_JOURNAL": "1",
           "LLMC_FAULTS": "crash@chunk=3", "LLMC_FAULTS_SEED": "7"}
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    argv = ["--models", ",".join([f"gpu:{RECOVERY_MODEL}"] * 4), "--judge",
            f"gpu:{RECOVERY_MODEL}", "--max-tokens", CLI_TOKENS, "--events", "--data-dir", data,
            PROMPT]
    try:
        call = cli_call(torch, counters, env, argv)
        if call["rc"] != 0:
            raise AssertionError(f"recovery (e): CLI exit {call['rc']}: {call['err']}")
        (run_id,) = os.listdir(data)
        files = read_run_dir(os.path.join(data, run_id))
        with open(os.path.join(data, run_id, "faults.txt"), encoding="utf-8") as f:
            trace = f.read().splitlines()
        (provider,) = [p for p in GPUProvider._shared.values() if p.journal is not None]
        stats = provider.recovery_stats()
    finally:
        faults.reset()
        fresh_planes()
        release_memory(torch)
    doc, metrics = files["result.json"], files["metrics.json"]
    warn = [w for w in doc.get("warnings", []) if not w.endswith(RANDOM_WEIGHT_WARNINGS)]
    crash = f"engine#3[model={RECOVERY_MODEL}]->crash"
    log(f"recovery (e): CLI exit 0 in {call['wall_s']:.2f} s wall, peak {call['peak_gb']:.2f} GB, "
        f"launches {call['launches']}, run directory {files['listing']}, faults.txt "
        f"{len(trace)} decisions (fired: {[ln for ln in trace if not ln.endswith('->-')]}), "
        f"stats {stats}")
    if (len(doc["responses"]) != 4 or doc.get("failed_models") or not doc["consensus"] or warn
            or "faults.txt" not in files["listing"] or crash not in trace
            or metrics.get("faults") != trace or stats["restarts"] != 1
            or stats["journal_depth"] != 0 or min(call["launches"].values()) <= 0):
        raise AssertionError(f"recovery (e): warnings {warn}, stats {stats}, trace {trace}, "
                             f"listing {files['listing']}, doc {json.dumps(doc)[:1500]}")
    return {"wall_s": call["wall_s"], "peak_gb": call["peak_gb"], "stats": stats,
            "launches": call["launches"], "listing": files["listing"], "fired": crash}


def run_recovery(torch, fa, da, card: str, seed: int) -> dict:
    """Phase 8e: (a) crash replay on llama-3-8b, (b) the wedge watchdog on
    consensus-1b, (c) the finite-logit sentinel on (a)'s rebuilt engine,
    (d) the WAL files of (a), (e) the batched slice's CLI through a crash.
    Any RuntimeWarning fails the phase. Prints a ``{"recovery": ...}``
    line."""
    import warnings

    t_phase = time.monotonic()
    fresh_planes()
    release_memory(torch)
    _TEACHER.clear()
    rows, part_s = {}, {}
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(prefix="chip-smoke-recovery-") as tmp:
        warnings.simplefilter("always")
        t = time.monotonic()
        rows["crash"], engine, journal = recovery_crash(torch, fa, da, tmp)
        part_s["crash"] = time.monotonic() - t
        t = time.monotonic()
        rows["wal"] = recovery_wal(journal, tmp)
        part_s["wal"] = time.monotonic() - t
        t = time.monotonic()
        rows["sentinel"] = recovery_sentinel(torch, engine, seed)
        part_s["sentinel"] = time.monotonic() - t
        del engine
        release_memory(torch)
        t = time.monotonic()
        rows["wedge"] = recovery_wedge(torch)
        part_s["wedge"] = time.monotonic() - t
        t = time.monotonic()
        rows["cli"] = recovery_cli(torch, fa, da, tmp)
        part_s["cli"] = time.monotonic() - t
    bad = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if bad:
        raise AssertionError(f"recovery: warnings {bad}")
    swaps = rows["crash"]["faults"]["min"]
    if swaps is None or swaps <= NEAR_TIE_TOL:
        raise AssertionError(f"recovery: the near-tie rule does not separate a misplaced row "
                             f"({swaps}) from the tolerance {NEAR_TIE_TOL}")
    rows["part_s"] = part_s
    log(f"recovery phase: {time.monotonic() - t_phase:.1f} s (by part, checks included: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()) + ")")
    print(json.dumps({"recovery": rows, "card": card}, default=str), flush=True)
    return rows


# -- phase 8f: the cross-request paged KV pool (kv/) ---------------------------

KV_MODEL = "llama-3-8b"
KV_BLOCK = 64
KV_MB = 4096.0
# A gather, a restore and a tail prefill against a fresh prefill of the same
# prompt: other chunk boundaries, so other bf16 orders (the session phase's
# bound).
KV_LOGIT_TOL = BATCH_LOGIT_TOL


def kv_walk(pool) -> list:
    """Every block of the pool's radix."""
    out, stack = [], [pool._radix.root]
    while stack:
        for child in stack.pop().children:
            out.append(child.block)
            stack.append(child)
    return out


def kv_text(torch, seed: int, n: int) -> str:
    """A random printable prompt of ``n`` bytes (``n`` + 1 byte tokens)."""
    return "".join(chr(t) for t in random_ids(torch, seed, n))


def kv_streams(torch, label: str, on, off, prompts: list, counters: dict, n: int = 48) -> tuple:
    """Greedy streams of ``prompts`` on ``on`` (a pool engine), then on
    ``off`` (the same weights without the pool). ``counters`` are reset
    before the pool-on streams and read after them, before ``off`` runs.
    A stream that reused the same prefix length on both engines (recorded
    at each engine's ``_reusable_prefix``, floored at its prefill chunk as
    ``_prefill_ids`` does) prefills the same chunks over the same bytes and
    must be equal; any other is held by the near-tie rule (``off`` the
    teacher). Returns the checks, the pool-on streams, each stream's
    ``(reuse on, reuse off)`` and the pool-on launches."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    s = SamplingParams(max_new_tokens=n, ignore_eos=True)
    reuse = {id(on): [], id(off): []}

    def run(eng) -> list:
        seen, lookup = reuse[id(eng)], eng._reusable_prefix

        def spy(ids):
            n_reused, saved = lookup(ids)
            seen.append(n_reused if n_reused >= eng.prefill_chunk else 0)
            return n_reused, saved

        eng._reusable_prefix = spy
        try:
            return [eng.generate_ids(p, s).token_ids for p in prompts]
        finally:
            del eng._reusable_prefix

    for c in counters.values():
        c.reset()
    got = run(on)
    launches = {name: c.count for name, c in counters.items()}
    ref = run(off)
    pairs = list(zip(reuse[id(on)], reuse[id(off)]))
    if len(pairs) != len(prompts):
        raise AssertionError(f"{label}: {reuse} reuse readings for {len(prompts)} prompts")
    checks = [greedy_check(torch, off, f"{label} {i}", p, g, r)
              for i, (p, g, r) in enumerate(zip(prompts, got, ref))]
    for check, (r_on, r_off) in zip(checks, pairs):
        check["reuse"] = [r_on, r_off]
    unequal = [i for i, (c, (r_on, r_off)) in enumerate(zip(checks, pairs))
               if r_on == r_off and not c["equal"]]
    log(f"  {label}: prefix reused pool on / off {pairs}; the same reuse must give the same "
        f"tokens")
    if unequal:
        raise AssertionError(f"{label}: streams {unequal} reused the same prefix pool on and "
                             f"off but differ: {[checks[i] for i in unequal]}")
    return checks, got, launches


def kvpool_mixed(torch, fa, da, off, seed: int) -> tuple:
    """(a) Mixed traffic on a 4,096 MB, 64-token-block pool (llama-3-8b bf16,
    the weights of ``off``): two prompts sharing a 1,101-token system prefix
    with different tails, an exact repeat, an unrelated 1,501-token prompt
    and a late third tail, 48 greedy tokens each, against ``off``. Returns
    the row, the pool engine and the prompts."""
    from llm_consensus_tpu_torch.engine import Engine

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    on = Engine(off.cfg, off.params, device=off.device, kv_pool=True, kv_pool_block=KV_BLOCK,
                kv_pool_mb=KV_MB)
    torch.cuda.synchronize()
    arena_alloc = torch.cuda.memory_allocated() - m0
    pool = on._kv_pool
    modeled = pool.n_blocks * pool.block_size * pool.bytes_per_token
    log(f"kvpool (a): {pool.n_blocks} blocks of {pool.block_size} tokens, {pool.bytes_per_token} "
        f"B a token ({pool.block_size * pool.bytes_per_token / 1e6:.2f} MB a block); arena "
        f"{modeled / 1e9:.3f} GB modeled, memory_allocated across the pool's construction "
        f"{arena_alloc / 1e9:.3f} GB")
    if arena_alloc != modeled or pool.arena_bytes != modeled:
        raise AssertionError(f"kvpool (a): arena {arena_alloc} B allocated, {modeled} modeled")
    bos = off.tokenizer.bos_id
    system = random_ids(torch, seed + 400, 1100, bos)
    tails = [random_ids(torch, seed + 401 + i, 60 + 20 * i) for i in range(3)]
    unrelated = random_ids(torch, seed + 410, 1500, bos)
    prompts = [system + tails[0], system + tails[1], system + tails[0], unrelated,
               system + tails[2]]
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    checks, got, launches = kv_streams(torch, "kvpool (a)", on, off, prompts, counters)
    stats = pool.stats()
    leased = sum(b.refs for b in kv_walk(pool))
    planted = fault_readings(torch, off, "kvpool (a)", prompts, got)
    row = {"blocks": pool.n_blocks, "bytes_per_token": pool.bytes_per_token,
           "arena_bytes": arena_alloc, "stats": stats, "leased": leased, "launches": launches,
           "equal": sum(c["equal"] for c in checks), "greedy": checks, "faults": planted}
    log(f"kvpool (a): {row['equal']}/5 streams equal to the pool-off engine's; hits "
        f"{stats['hits']} ({stats['hit_tokens']} tokens), misses' tokens {stats['miss_tokens']}, "
        f"{stats['published_blocks']} blocks published, leases held {leased}; pool-on launches "
        f"{launches}")
    if stats["hits"] < 3 or leased or launches["decode_attention"] <= 0:
        raise AssertionError(f"kvpool (a): {stats}, leased {leased}, launches {launches}")
    if row["equal"] < 5 and (planted["min"] is None or planted["min"] <= NEAR_TIE_TOL):
        raise AssertionError(f"kvpool (a): the near-tie rule does not separate a misplaced row "
                             f"({planted['min']}) from the tolerance {NEAR_TIE_TOL}")
    return row, on, prompts


def kvpool_batcher(torch, fa, da, on, off, unrelated: list, seed: int) -> dict:
    """(f) A lone 1,501-token request whose first 23 blocks the pool of (a)
    holds (the unrelated prompt's): ``ContinuousBatcher(max_batch=4)``
    establishes its prefix by radix consult (a gather) and decodes it as a
    suffix through the decode kernel's ``return_state`` form; the same
    request on ``off``'s batcher admits whole. Both against single-stream."""
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    q = unrelated[:23 * KV_BLOCK] + random_ids(torch, seed + 430, 29)
    held = on._kv_pool.match_len(q[:-1])
    s = SamplingParams(max_new_tokens=48, ignore_eos=True)
    runs = {}
    for label, eng in (("pool", on), ("no pool", off)):
        counters = (fa.LAUNCHES, da.LAUNCHES, da.LAUNCHES_STATE)
        for c in counters:
            c.reset()
        b = ContinuousBatcher(eng, max_batch=4)
        try:
            t0 = time.monotonic()
            r = b.submit_ids(q, s).result(timeout=600)
            wall = time.monotonic() - t0
            snap = b.snapshot()
        finally:
            b.close()
        runs[label] = {"tokens": r.token_ids, "wall_s": wall,
                       "establish_s": snap["establish_s"],
                       "establish_tokens": snap["establish_tokens"],
                       "admit_s": snap["admit_s"], "prefix_len": snap["prefix_len"],
                       "launches": dict(zip(("flash_attention", "decode_attention",
                                             "decode_attention_state"),
                                            (c.count for c in counters)))}
    ref = off.generate_ids(q, s).token_ids
    checks = [greedy_check(torch, off, f"kvpool (f) {label}", q, run["tokens"], ref)
              for label, run in runs.items()]
    on_run, off_run = runs["pool"], runs["no pool"]
    log(f"kvpool (f): the pool holds {held} of the request's tokens; established "
        f"{on_run['establish_tokens']} in {1e3 * on_run['establish_s']:.2f} ms (+ suffix admit "
        f"{1e3 * on_run['admit_s']:.2f} ms) against the whole request's admission "
        f"{1e3 * off_run['admit_s']:.2f} ms without the pool; launches {on_run['launches']} "
        f"/ {off_run['launches']}")
    if (held < 23 * KV_BLOCK or on_run["establish_tokens"] != held
            or on_run["launches"]["decode_attention_state"] <= 0
            or off_run["establish_tokens"] != 0):
        raise AssertionError(f"kvpool (f): {runs}")
    return {"held": held, "runs": {k: {x: y for x, y in v.items() if x != "tokens"}
                                   for k, v in runs.items()}, "greedy": checks}


def kvpool_follow_up(torch, on, off, seed: int) -> dict:
    """(b) The session phase's follow-up: the 1,501-token prompt and 48
    tokens, then it with its answer and a 200-token follow-up (1,749
    tokens) on a pool hit against a fresh engine: prefill, gather and
    publish ms (CUDA events, median of 5), the first-step logits, and the
    memory the hit adds at its peak (one gathered cache)."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams

    pool = on._kv_pool
    fresh = Engine(off.cfg, off.params, device=off.device, prefix_cache=False)
    ids = random_ids(torch, seed, 1500, bos=off.tokenizer.bos_id)
    first = on.generate_ids(ids, SamplingParams(max_new_tokens=48, ignore_eos=True))
    follow = ids + first.token_ids + random_ids(torch, seed + 1, 200)
    published = pool.match_len(follow)
    cache_gb = pool.max_seq * pool.bytes_per_token / 1e9
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        lg_hit, cache = on._prefill_ids(follow)
        torch.cuda.synchronize()
        rise_gb = (torch.cuda.max_memory_allocated() - a0) / 1e9
        del cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        lg_fresh, fresh_cache = fresh._prefill_ids(follow)
        torch.cuda.synchronize()
        fresh_rise_gb = (torch.cuda.max_memory_allocated() - a0) / 1e9
        logit_err = max_err(lg_hit, lg_fresh)
        hit_ms = median_ms(torch, lambda: on._prefill_ids(follow))
        fresh_ms = median_ms(torch, lambda: fresh._prefill_ids(follow))
        k_gather = -(-min(published, len(follow) - 1) // KV_BLOCK)
        gather_ms = median_ms(torch, lambda: pool.lookup(follow, on.prefill_chunk))

        def republish():
            pool.evict_cold(0.0)  # host only: the publish below writes every block
            pool.publish(follow, fresh_cache)

        publish_ms = median_ms(torch, republish)
    k_publish = -(-len(follow) // KV_BLOCK)
    row = {"prompt_tokens": len(follow), "published_before": published,
           "prefill_ms_hit": hit_ms, "prefill_ms_fresh": fresh_ms, "gather_ms": gather_ms,
           "gather_blocks": k_gather, "publish_ms": publish_ms, "publish_blocks": k_publish,
           "first_logits_max_abs_diff": logit_err, "hit_peak_rise_gb": rise_gb,
           "fresh_peak_rise_gb": fresh_rise_gb, "gathered_cache_gb": cache_gb,
           "snapshot_pr9": {"prefill_ms_reuse": 74.22, "reused": 1549,
                            "prefill_ms_fresh": 188.72}}
    log(f"kvpool (b): follow-up of {len(follow)} tokens, {published} published by the first "
        f"generate; prefill {hit_ms:.2f} ms on a pool hit against {fresh_ms:.2f} ms fresh (CUDA "
        f"events, median of 5; the snapshot in PR 9: 74.22 ms reusing 1,549 against 188.72); "
        f"gather of {k_gather} blocks {gather_ms:.3f} ms, publish of {k_publish} blocks "
        f"{publish_ms:.3f} ms; first-step logits max |diff| {logit_err:.3e} (tol "
        f"{KV_LOGIT_TOL}); the hit's peak adds {rise_gb:.3f} GB, a fresh prefill's "
        f"{fresh_rise_gb:.3f} GB (one cache {cache_gb:.3f} GB each)")
    # A hit holds one full-capacity cache, as a fresh prefill does: a
    # restore that copied the gathered cache would add a second.
    if (published != 1549 or logit_err > KV_LOGIT_TOL or rise_gb < cache_gb
            or rise_gb > fresh_rise_gb + 0.5 * cache_gb):
        raise AssertionError(f"kvpool (b): {row}")
    del fresh, fresh_cache
    return row


def kvpool_eviction(torch, off, seed: int) -> dict:
    """(c) The default 256 MB arena (30 blocks, 1,920 tokens) under four
    distinct 1,501-token prompts (16 tokens each): LRU eviction, outputs
    held as in (a)."""
    from llm_consensus_tpu_torch.engine import Engine

    small = Engine(off.cfg, off.params, device=off.device, kv_pool=True,
                   kv_pool_block=KV_BLOCK)
    prompts = [random_ids(torch, seed + 420 + i, 1500, off.tokenizer.bos_id) for i in range(4)]
    checks, _, _ = kv_streams(torch, "kvpool (c)", small, off, prompts, {}, n=16)
    stats = small._kv_pool.stats()
    log(f"kvpool (c): {stats['blocks_total']} blocks; {stats['evicted_blocks']} evicted, "
        f"{stats['blocks_used']} used, {stats['published_blocks']} published; "
        f"{sum(c['equal'] for c in checks)}/4 streams equal")
    if not (stats["evicted_blocks"] > 0 and stats["blocks_used"] <= stats["blocks_total"] == 30):
        raise AssertionError(f"kvpool (c): {stats}")
    del small
    return {"stats": stats, "greedy": checks}


def kvpool_int8(torch, da, off, prompts: list) -> dict:
    """(d) The int8 cache: (a)'s shared-prefix pair with ``kv_quant="int8"``
    (16 tokens each), the pool on (1,024 MB) against off; blocks carry codes
    and scales, the int8 decode kernel runs."""
    from llm_consensus_tpu_torch.engine import Engine

    q_on = Engine(off.cfg, off.params, device=off.device, kv_quant="int8", kv_pool=True,
                  kv_pool_block=KV_BLOCK, kv_pool_mb=1024.0)
    q_off = Engine(off.cfg, off.params, device=off.device, kv_quant="int8")
    checks, _, counted = kv_streams(torch, "kvpool (d)", q_on, q_off, prompts[:2],
                                    {"int8": da.LAUNCHES_INT8}, n=16)
    stats = q_on._kv_pool.stats()
    launches = counted["int8"]
    log(f"kvpool (d): int8 cache, {stats['bytes_per_token']} B a token, {stats['blocks_total']} "
        f"blocks; hits {stats['hits']} ({stats['hit_tokens']} tokens); int8 decode launches "
        f"{launches}; {sum(c['equal'] for c in checks)}/2 streams equal")
    if stats["hits"] < 1 or launches <= 0:
        raise AssertionError(f"kvpool (d): {stats}, int8 launches {launches}")
    del q_on, q_off
    return {"stats": stats, "int8_launches": launches, "greedy": checks}


def kvpool_faults(torch, off, seed: int) -> dict:
    """(e) Each against a clean run of a 600-token prompt (16 tokens):
    ``pool_exhausted@step=1`` through the provider (the response's ``kv``),
    ``hbm_squeeze@phase=publish@frac=0@step=1`` (the same truncation and the
    ledger's ``hbm`` event), and the integrity plane at ``sample=1.0`` with
    ``bit_flip@surface=kv`` (one corrupt block, the lookup a miss, the
    output equal to the clean run)."""
    from llm_consensus_tpu_torch import faults, integrity, obs
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.faults import FaultPlan
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.context import Context

    text = kv_text(torch, seed + 440, 600)
    ids = off.tokenizer.encode(text)
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    clean = off.generate_ids(ids, s).token_ids

    def pool_engine():
        return Engine(off.cfg, off.params, device=off.device, kv_pool=True,
                      kv_pool_block=KV_BLOCK)

    row = {}
    faults.install(FaultPlan("pool_exhausted@step=1", seed=3))
    try:
        eng = pool_engine()
        provider = GPUProvider(kv_pool=True, ignore_eos=True)
        provider._engines[KV_MODEL] = eng
        resp = provider.query(Context.background(),
                              Request(model=f"gpu:{KV_MODEL}", prompt=text, max_tokens=16))
        stats = eng._kv_pool.stats()
        row["pool_exhausted"] = {"response_kv": resp.kv, "exhausted": stats["exhausted"],
                                 "published_blocks": stats["published_blocks"],
                                 "tokens": resp.tokens}
        provider._engines.clear()
        del eng, provider
    finally:
        faults.reset()
    if row["pool_exhausted"]["response_kv"] != {"truncated": True} or \
            row["pool_exhausted"]["exhausted"] != 1:
        raise AssertionError(f"kvpool (e) pool_exhausted: {row['pool_exhausted']}")

    prev = obs.attrib.ledger()
    led = obs.attrib.ChipTimeLedger()
    obs.attrib.install(led)
    faults.install(FaultPlan("hbm_squeeze@phase=publish@frac=0@step=1", seed=5))
    try:
        eng = pool_engine()
        r = eng.generate_ids(ids, s)
        stats = eng._kv_pool.stats()
        row["hbm_squeeze"] = {"kv_truncated": r.kv_truncated, "exhausted": stats["exhausted"],
                              "hbm_events": led.snapshot()["hbm"]["events"],
                              "equal": r.token_ids == clean}
        del eng
    finally:
        faults.reset()
        obs.attrib.install(prev)
    if not (row["hbm_squeeze"]["kv_truncated"] and row["hbm_squeeze"]["exhausted"] == 1
            and row["hbm_squeeze"]["hbm_events"] == 1 and row["hbm_squeeze"]["equal"]):
        raise AssertionError(f"kvpool (e) hbm_squeeze: {row['hbm_squeeze']}")

    plane = integrity.IntegrityPlane(sample=1.0)
    integrity.install(plane)
    faults.install(FaultPlan("bit_flip@surface=kv", seed=2))
    try:
        eng = pool_engine()
        first = eng.generate_ids(ids, s).token_ids
        hits0 = eng._kv_pool.stats()["hit_tokens"]
        second = eng.generate_ids(ids, s).token_ids
        stats = eng._kv_pool.stats()
        row["bit_flip"] = {"corrupt_blocks": stats["corrupt_blocks"],
                           "verified_blocks": stats["verified_blocks"],
                           "failures": plane.stats()["failures"],
                           "equal": first == clean and second == clean,
                           "hits": stats["hits"]}
        # The corrupt lookup dropped its chain: the generate republished it.
        row["bit_flip"]["republished"] = eng._kv_pool.match_len(ids) >= len(ids) - 1
        del eng
    finally:
        faults.reset()
        integrity.reset()
    log(f"kvpool (e): pool_exhausted → response kv {row['pool_exhausted']['response_kv']}, "
        f"exhausted {row['pool_exhausted']['exhausted']}; hbm_squeeze → truncated "
        f"{row['hbm_squeeze']['kv_truncated']}, hbm events {row['hbm_squeeze']['hbm_events']}; "
        f"bit_flip → corrupt blocks {row['bit_flip']['corrupt_blocks']} of "
        f"{row['bit_flip']['verified_blocks']} verified, failures "
        f"{row['bit_flip']['failures']}, outputs equal to the clean run "
        f"{row['bit_flip']['equal']} (hit tokens before {hits0})")
    if not (row["bit_flip"]["corrupt_blocks"] == 1 and row["bit_flip"]["equal"]
            and row["bit_flip"]["failures"] == {"kv": 1}):
        raise AssertionError(f"kvpool (e) bit_flip: {row['bit_flip']}")
    return row


def kvpool_cli(torch, fa, da, tmp: str) -> dict:
    """(g) The slice's CLI with ``LLMC_KV_POOL=1 LLMC_KV_POOL_MB=4096
    --rounds 2 --events``, auto-saved, then the same run with the pool off:
    exit 0, flash launched on the pool's misses (the one-chunk panel
    prompts), a ``kv`` block in ``metrics.json`` for every ``gpu:`` preset,
    and ``result.json``'s keys equal to the pool-off run's."""
    runs = {}
    for label, env in (("pool", {"LLMC_KV_POOL": "1", "LLMC_KV_POOL_MB": "4096"}),
                       ("no pool", {})):
        fresh_planes()
        release_memory(torch)
        root = os.path.join(tmp, label.replace(" ", "_"))
        os.makedirs(root)
        argv = ["--models", SESSION_PANEL, "--judge", SESSION_JUDGE, "--max-tokens", CLI_TOKENS,
                "--rounds", "2", "--events", "--data-dir", root, PROMPT]
        call = cli_call(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES},
                        env, argv)
        if call["rc"] != 0:
            raise AssertionError(f"kvpool (g) {label}: CLI exit {call['rc']}: {call['err']}")
        (run_id,) = os.listdir(root)
        files = read_run_dir(os.path.join(root, run_id))
        runs[label] = {"wall_s": call["wall_s"], "peak_gb": call["peak_gb"],
                       "launches": call["launches"], "files": files}
    on, off = runs["pool"], runs["no pool"]
    kv = on["files"]["metrics.json"].get("kv", {})
    doc_on, doc_off = on["files"]["result.json"], off["files"]["result.json"]
    keys_equal = (list(doc_on) == list(doc_off) and [list(r) for r in doc_on["responses"]]
                  == [list(r) for r in doc_off["responses"]])
    row = {"wall_s": {k: v["wall_s"] for k, v in runs.items()},
           "peak_gb": {k: v["peak_gb"] for k, v in runs.items()},
           "launches": {k: v["launches"] for k, v in runs.items()},
           "kv": kv, "result_keys_equal": keys_equal,
           "no_pool_kv": "kv" in off["files"]["metrics.json"]}
    log(f"kvpool (g): the CLI with the pool {on['wall_s']:.2f} s (peak {on['peak_gb']:.2f} GB, "
        f"launches {on['launches']}), without {off['wall_s']:.2f} s (peak "
        f"{off['peak_gb']:.2f} GB); kv blocks " + ", ".join(
            f"{preset}: hits {st['hits']} ({st['hit_tokens']} tokens) of {st['lookups']} "
            f"lookups, {st['published_blocks']} blocks published" for preset, st in
            sorted(kv.items())) + f"; result.json keys equal {keys_equal}")
    if (sorted(kv) != sorted(m.split(":", 1)[1] for m in SESSION_PANEL.split(","))
            or not keys_equal or row["no_pool_kv"]
            or on["launches"]["flash_attention"] <= 0 or on["launches"]["decode_attention"] <= 0):
        raise AssertionError(f"kvpool (g): {row}")
    return row


def run_kvpool(torch, fa, da, card: str, seed: int) -> dict:
    """Phase 8f on llama-3-8b bf16 (random weights from the seed): (a) mixed
    traffic pool on and off, (f) the batcher's radix consult, (b) the
    follow-up on a pool hit, (c) eviction at the default arena, (d) the
    int8 cache, (e) faults and integrity, (g) the CLI. Any RuntimeWarning
    fails the phase. Prints a ``{"kvpool": ...}`` line."""
    import warnings

    from llm_consensus_tpu_torch.engine import Engine
    from llm_consensus_tpu_torch.models import get_config

    t_phase = time.monotonic()
    fresh_planes()
    release_memory(torch)
    _TEACHER.clear()
    torch.cuda.reset_peak_memory_stats()
    rows, part_s = {}, {}
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(prefix="chip-smoke-kvpool-") as tmp:
        warnings.simplefilter("always")
        off = Engine(get_config(KV_MODEL), device=torch.device("cuda"))
        t = time.monotonic()
        rows["mixed"], on, prompts = kvpool_mixed(torch, fa, da, off, seed)
        part_s["mixed"] = time.monotonic() - t
        t = time.monotonic()
        rows["batcher"] = kvpool_batcher(torch, fa, da, on, off, prompts[3], seed)
        part_s["batcher"] = time.monotonic() - t
        t = time.monotonic()
        rows["follow_up"] = kvpool_follow_up(torch, on, off, seed)
        part_s["follow_up"] = time.monotonic() - t
        rows["arena_stats"] = on._kv_pool.stats()
        del on
        release_memory(torch)
        t = time.monotonic()
        rows["eviction"] = kvpool_eviction(torch, off, seed)
        part_s["eviction"] = time.monotonic() - t
        t = time.monotonic()
        rows["int8"] = kvpool_int8(torch, da, off, prompts)
        part_s["int8"] = time.monotonic() - t
        t = time.monotonic()
        rows["faults"] = kvpool_faults(torch, off, seed)
        part_s["faults"] = time.monotonic() - t
        peak_engines_gb = torch.cuda.max_memory_allocated() / 1e9
        del off
        _TEACHER.clear()
        release_memory(torch)
        t = time.monotonic()
        rows["cli"] = kvpool_cli(torch, fa, da, tmp)
        part_s["cli"] = time.monotonic() - t
        fresh_planes()
        release_memory(torch)
    bad = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if bad:
        raise AssertionError(f"kvpool: warnings {bad}")
    mixed = rows["mixed"]
    summary = {
        "card": card, "phase_s": time.monotonic() - t_phase, "part_s": part_s,
        "arena_bytes": mixed["arena_bytes"], "blocks": mixed["blocks"],
        "hits": mixed["stats"]["hits"], "misses": mixed["stats"]["lookups"]
        - mixed["stats"]["hits"], "evicted": rows["eviction"]["stats"]["evicted_blocks"],
        "exhausted": rows["faults"]["pool_exhausted"]["exhausted"]
        + rows["faults"]["hbm_squeeze"]["exhausted"],
        "corrupt": rows["faults"]["bit_flip"]["corrupt_blocks"],
        "prefill_ms_hit": rows["follow_up"]["prefill_ms_hit"],
        "prefill_ms_fresh": rows["follow_up"]["prefill_ms_fresh"],
        "gather_ms": rows["follow_up"]["gather_ms"],
        "publish_ms": rows["follow_up"]["publish_ms"],
        "peak_gb": peak_engines_gb,
        "launches": {"mixed": mixed["launches"],
                     "batcher": rows["batcher"]["runs"]["pool"]["launches"],
                     "int8": rows["int8"]["int8_launches"], "cli": rows["cli"]["launches"]},
    }
    log(f"kvpool phase: {summary['phase_s']:.1f} s (by part, checks included: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()) + ")")
    print(json.dumps({"kvpool": summary, "parts": rows}, default=str), flush=True)
    return rows


# -- phases 12 to 16: Mixtral and the checkpoint loader ------------------------

MIXTRAL = "mixtral-8x7b"
# moe_block in float32 on the card (TF32 off) against float32 on the CPU at
# Mixtral's widths: sums of 4,096 and 14,336 products in another order, on
# outputs of magnitude ~1.
MOE_TOL = 1e-4


# -- phase 8g: speculative decoding ----------------------------------------------------

SPEC_TARGET, SPEC_DRAFT = "llama-3-8b", "llama-3.2-1b"
SPEC_K = 4
SPEC_TOKENS = 48       # (a)
SPEC_CLI_TOKENS = "16"  # (g)'s drafted slice, tokens a model
SPEC_SWEEP_TOKENS = 48  # (b), (c), (e); one run at each point of (b)
ORACLE_ACCEPTS = (1, 3, 5)  # (b)'s points (2 was cut for the parallel phase)
SPEC_GOVERNOR_TOKENS = 160  # (d): a 64-token drafted probe, a 64-token plain one, then locked


def check_kernels_dh64(torch, flash_rec: dict, decode_rec: dict) -> None:
    """The llama-3.2-1b shapes (dh 64, 32 query and 8 KV heads) of both
    kernels against their plain versions, timed warm and cold beside their
    bound and SDPA: flash q[1,512,32,64] over kv[1,512,8,64]; decode
    q[1,1,32,64] over a [16,1,8192,8,64] cache at width 384 (the draft's
    steps on the spec phase's prompt)."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(64)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, dh, t = 32, 8, 64, 512
    q, k, v = rnd(1, t, hq, dh), rnd(1, t, hkv, dh), rnd(1, t, hkv, dh)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = max_err(got, fa.flash_attention_plain(q, k, v))
    log(f"flash  llama-3.2-1b prefill q[1,{t},{hq},{dh}] kv[1,{t},{hkv},{dh}]: max_abs_err "
        f"{err:.3e} (tol {FLASH_TOL})")
    if not bool(torch.isfinite(got).all()) or err > FLASH_TOL:
        raise AssertionError(f"flash_attention dh 64: err {err}")
    kern = timed(lambda: fa.flash_attention(q, k, v), 50)
    plain_ms, _ = device_time_ms(lambda: fa.flash_attention_plain(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = kt.repeat_interleave(hq // hkv, 1), vt.repeat_interleave(hq // hkv, 1)
    lib = timed(lambda: sdpa(qt, kt, vt, is_causal=True), 50)
    bms, by = bound_ms(2.0 * (2 * t * hq * dh + 2 * t * hkv * dh), 4.0 * hq * dh * t * (t + 1) / 2)
    flash_rec.update(
        name="flash_attention_dh64", route="cuda",
        source="llm_consensus_tpu_torch/csrc/flash_attention.cu",
        replaces="llm_consensus_tpu/ops/pallas/flash_attention.py:136",
        shapes=f"q[1,{t},{hq},{dh}] k/v[1,{t},{hkv},{dh}] bf16 (llama-3.2-1b)",
        max_abs_err=err, ms=kern["ms"], cold_ms=kern["cold_ms"], plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, bound_share=bms / kern["cold_ms"],
        library_ms=lib["ms"], library_cold_ms=lib["cold_ms"], launches=0)
    log(f"flash  timing dh 64: kernel warm {kern['ms']:.4f} ms, cold {kern['cold_ms']:.4f} ms; "
        f"sdpa warm {lib['ms']:.4f}, cold {lib['cold_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
        f"bound {bms:.5f} ms ({by})")
    del q, k, v, qt, kt, vt

    L, S, layer, pos, w = 16, 8192, 5, 383, 384
    k, v, q = rnd(L, 1, S, hkv, dh), rnd(L, 1, S, hkv, dh), rnd(1, 1, hq, dh)
    k[layer, :, pos + 1:] = float("nan")  # never read: past the frontier
    v[layer, :, pos + 1:] = float("nan")
    pos_t = torch.full((), pos, dtype=torch.int32, device="cuda")
    layer_t = torch.full((), layer, dtype=torch.int32, device="cuda")
    rs0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q, k, v, pos, layer, rs0, kv_width=w)
    err, tol = max_err(got, want), decode_tol(want)
    log(f"decode llama-3.2-1b q[1,1,{hq},{dh}] cache[{L},1,{S},{hkv},{dh}] pos {pos} width {w}: "
        f"max_abs_err {err:.3e} (tol {tol:.3e})")
    if not bool(torch.isfinite(got).all()) or err > tol:
        raise AssertionError(f"decode_attention dh 64: err {err}")
    k[layer, :, pos + 1:] = 0.0
    v[layer, :, pos + 1:] = 0.0
    kern = timed(lambda: da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w), 200)
    plain_ms, _ = device_time_ms(
        lambda: da.decode_attention_plain(q, k, v, pos_t, layer_t, rs0, kv_width=w), 10)
    qt = q.transpose(1, 2)
    kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
    vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
    lib = timed(lambda: sdpa(qt, kt, vt), 200)
    n_valid = pos + 1
    bms, by = bound_ms(2.0 * (2 * n_valid * hkv * dh + 2 * hq * dh), 4.0 * hq * dh * n_valid)
    decode_rec.update(
        name="decode_attention_dh64", route="cuda",
        source="llm_consensus_tpu_torch/csrc/decode_attention.cu",
        replaces="llm_consensus_tpu/ops/pallas/decode_attention.py:415",
        shapes=f"q[1,1,{hq},{dh}] cache[{L},1,{S},{hkv},{dh}] bf16 (llama-3.2-1b), pos {pos}, "
               f"kv_width {w}",
        max_abs_err=err, ms=kern["ms"], cold_ms=kern["cold_ms"], plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, bound_share=bms / kern["cold_ms"],
        library_ms=lib["ms"], library_cold_ms=lib["cold_ms"], launches=0)
    log(f"decode timing dh 64 width {w}: kernel warm {kern['ms']:.4f} ms, cold "
        f"{kern['cold_ms']:.4f} ms; sdpa warm {lib['ms']:.4f}, cold {lib['cold_ms']:.4f} ms; "
        f"plain {plain_ms:.4f} ms; bound {bms:.5f} ms ({by})")
    del k, v, kt, vt
    release_memory(torch)


class HostFetches:
    """Counts the speculative loops' host copies (``speculative._to_host``)
    while the block runs."""

    def __init__(self) -> None:
        self.count = 0

    def __enter__(self) -> "HostFetches":
        from llm_consensus_tpu_torch.engine import speculative as spec_mod

        self._mod, self._real = spec_mod, spec_mod._to_host

        def counted(tensors):
            self.count += 1
            return self._real(tensors)

        spec_mod._to_host = counted
        return self

    def __exit__(self, *exc) -> None:
        self._mod._to_host = self._real


def spec_rate(res) -> float:
    """Tokens per second over the whole request (host clock)."""
    return len(res.token_ids) / (res.latency_ms / 1e3)


def spec_model_draft(torch, fa, da, tgt, drf, ids, plain) -> dict:
    """(a) the llama-3.2-1b drafter, greedy, k = 4, adaptive and governor
    off: launches (flash once a layer on both prompts, the decode kernel in
    every draft step, none in a verify), host fetches per round group, the
    tokens against plain decode."""
    from llm_consensus_tpu_torch.engine import SamplingParams, SpeculativeEngine

    spec = SpeculativeEngine(tgt, drf, k=SPEC_K, adaptive=False, governor=False)
    s = SamplingParams(max_new_tokens=SPEC_TOKENS, ignore_eos=True)
    fa.LAUNCHES.reset()
    da.LAUNCHES.reset()
    with HostFetches() as fetches:
        got = spec.generate(PROMPT, s)
    flash_n, decode_n = fa.LAUNCHES.count, da.LAUNCHES.count
    rounds = spec.stats["rounds"]
    row = {"rounds": rounds, "mean_accepted": spec.mean_accepted, "flash": flash_n,
           "decode": decode_n, "fetches": fetches.count, "rounds_per_fetch": spec.rounds,
           "tokens_per_s": spec_rate(got), "plain_tokens_per_s": spec_rate(plain),
           "check": greedy_check(torch, tgt, "(a) llama-3.2-1b draft", ids, got.token_ids,
                                 plain.token_ids)}
    layers_t, layers_d = tgt.cfg.n_layers, drf.cfg.n_layers
    log(f"(a) model draft k {SPEC_K}: {rounds} rounds, mean accepted {spec.mean_accepted:.3f}, "
        f"flash {flash_n} launches (want {layers_t} + {layers_d}), decode {decode_n} (want "
        f"{rounds} x {SPEC_K + 1} x {layers_d}), host fetches {fetches.count} for "
        f"{-(-rounds // spec.rounds)} round groups; {row['tokens_per_s']:.2f} tokens/s "
        f"against plain {row['plain_tokens_per_s']:.2f} (host clock, whole request)")
    if flash_n != layers_t + layers_d or decode_n != rounds * (SPEC_K + 1) * layers_d:
        raise AssertionError(f"(a) launches: flash {flash_n}, decode {decode_n}, {rounds} rounds")
    if fetches.count > -(-rounds // spec.rounds) + 1:
        raise AssertionError(f"(a) {fetches.count} host fetches for {rounds} rounds")
    return row


def spec_oracle_sweep(torch, tgt, ids, plain) -> dict:
    """(b) the oracle at forced acceptance 1, 3 and 5 (k = 4; 2 was cut to fit
    the parallel phase) against plain decode: tokens/s over the request,
    host clock, one run each."""
    from llm_consensus_tpu_torch.engine import OracleDrafter, SamplingParams, SpeculativeEngine

    s = SamplingParams(max_new_tokens=SPEC_SWEEP_TOKENS, ignore_eos=True)
    cont = plain.token_ids[:SPEC_SWEEP_TOKENS]
    rates = {"plain": [spec_rate(tgt.generate(PROMPT, s))]}
    means = {}
    for accept in ORACLE_ACCEPTS:
        spec = SpeculativeEngine(tgt, OracleDrafter(cont, accept=accept), k=SPEC_K,
                                 adaptive=False, governor=False)
        runs = [spec.generate(PROMPT, s)]
        for r in runs:
            greedy_check(torch, tgt, f"(b) oracle accept {accept}", ids, r.token_ids, cont)
        rates[accept] = sorted(spec_rate(r) for r in runs)
        means[accept] = spec.mean_accepted
    med = {key: v[0] for key, v in rates.items()}
    log("(b) oracle sweep, tokens/s (one run each): " + "; ".join(
        f"{key}: {v[0]:.2f}" for key, v in rates.items()) + f"; mean accepted {means}")
    return {"rates": rates, "median": med, "mean_accepted": means,
            "speedup": {a: med[a] / med["plain"] for a in ORACLE_ACCEPTS}}


def spec_lookup(torch, tgt, plain) -> dict:
    """(c) the prompt-lookup drafter on a judge prompt quoting two answers."""
    from llm_consensus_tpu_torch.consensus import render_judge_prompt
    from llm_consensus_tpu_torch.engine import PromptLookupDrafter, SamplingParams, SpeculativeEngine
    from llm_consensus_tpu_torch.providers import Response

    answers = [Response("gpu:llama-3-8b", plain.text, "gpu"),
               Response("gpu:consensus-1b", PROMPT[:400], "gpu")]
    judge = render_judge_prompt(PROMPT, answers)
    s = SamplingParams(max_new_tokens=SPEC_SWEEP_TOKENS, ignore_eos=True)
    want = tgt.generate(judge, s)
    spec = SpeculativeEngine(tgt, PromptLookupDrafter(), k=SPEC_K, governor=False)
    got = spec.generate(judge, s)
    jids = tgt._budget_prompt(tgt.tokenizer.encode(judge), SPEC_SWEEP_TOKENS)[0]
    row = {"prompt_tokens": len(jids), "mean_accepted": spec.mean_accepted,
           "rounds": spec.stats["rounds"], "tokens_per_s": spec_rate(got),
           "plain_tokens_per_s": spec_rate(want),
           "check": greedy_check(torch, tgt, "(c) prompt lookup", jids, got.token_ids,
                                 want.token_ids)}
    log(f"(c) prompt lookup on a {len(jids)}-token judge prompt: mean accepted "
        f"{spec.mean_accepted:.3f} over {row['rounds']} rounds, {row['tokens_per_s']:.2f} "
        f"tokens/s against plain {row['plain_tokens_per_s']:.2f}")
    return row


def spec_governor(torch, tgt, drf, ids) -> dict:
    """(d) the governor on, with the random llama-3.2-1b drafter: it locks
    plain after its probes; the rate against plain's."""
    from llm_consensus_tpu_torch.engine import SamplingParams, SpeculativeEngine

    s = SamplingParams(max_new_tokens=SPEC_GOVERNOR_TOKENS, ignore_eos=True)
    plain = [tgt.generate(PROMPT, s)]
    spec = SpeculativeEngine(tgt, drf, k=SPEC_K)
    got = spec.generate(PROMPT, s)
    plain_rates = sorted(spec_rate(r) for r in plain)
    row = {"governor": got.spec["governor"], "disables": spec.stats["governor_disables"],
           "plain_tokens": got.spec["plain_tokens"], "tokens_per_s": spec_rate(got),
           "decode_tokens_per_s": got.decode_tokens / got.decode_s if got.decode_s else None,
           "plain_tokens_per_s": plain_rates,
           "check": greedy_check(torch, tgt, "(d) governor on", ids, got.token_ids,
                                 plain[0].token_ids)}
    log(f"(d) governor on: {row['governor']}, disables {row['disables']}, plain tokens "
        f"{row['plain_tokens']} of {len(got.token_ids)}; {row['tokens_per_s']:.2f} tokens/s "
        f"against plain {plain_rates[0]:.2f} (one run, whole request)")
    if row["disables"] < 1:
        raise AssertionError(f"(d) the governor never locked plain: {got.spec}")
    return row


def spec_sampled_and_fault(torch, tgt, drf, ids, plain) -> dict:
    """(e) rejection sampling at temperature 0.8 with the model drafter
    (every probability finite), then ``acceptance_collapse@p=1`` greedy."""
    from llm_consensus_tpu_torch import faults
    from llm_consensus_tpu_torch.engine import SamplingParams, SpeculativeEngine
    from llm_consensus_tpu_torch.engine import speculative as spec_mod

    flags = []
    real = spec_mod.rejection_accept

    def checked(ps, qs, drafts, us):
        flags.append(torch.isfinite(ps).all() & torch.isfinite(qs).all())
        return real(ps, qs, drafts, us)

    spec_mod.rejection_accept = checked
    try:
        spec = SpeculativeEngine(tgt, drf, k=SPEC_K)
        s = SamplingParams(max_new_tokens=SPEC_SWEEP_TOKENS, temperature=0.8, seed=3,
                           ignore_eos=True)
        got = spec.generate(PROMPT, s)
    finally:
        spec_mod.rejection_accept = real
    finite = bool(torch.stack(flags).all()) if flags else False
    row = {"sampled_tokens": len(got.token_ids), "sampled_mean_accepted": spec.mean_accepted,
           "sampled_rounds": spec.stats["rounds"], "finite": finite}
    if len(got.token_ids) != SPEC_SWEEP_TOKENS or not finite or not spec.stats["rounds"]:
        raise AssertionError(f"(e) sampled: {row}")
    faults.install(faults.FaultPlan("acceptance_collapse@p=1@times=-1", seed=5))
    try:
        spec = SpeculativeEngine(tgt, drf, k=SPEC_K, adaptive=False, governor=False)
    finally:
        faults.reset()
    s = SamplingParams(max_new_tokens=SPEC_SWEEP_TOKENS, ignore_eos=True)
    got = spec.generate(PROMPT, s)
    row["collapse_faults"] = spec.stats["collapse_faults"]
    row["collapse_mean_accepted"] = spec.mean_accepted
    row["collapse_check"] = greedy_check(torch, tgt, "(e) acceptance_collapse", ids,
                                         got.token_ids, plain.token_ids[:SPEC_SWEEP_TOKENS])
    log(f"(e) sampled at 0.8: {len(got.token_ids)} tokens, {row['sampled_rounds']} rounds, "
        f"mean accepted {row['sampled_mean_accepted']:.3f}, every p and q finite; "
        f"acceptance_collapse: {row['collapse_faults']} junked rounds, mean accepted "
        f"{row['collapse_mean_accepted']:.3f}")
    if row["collapse_faults"] <= 0:
        raise AssertionError(f"(e) the collapse fault never fired: {row}")
    return row


def spec_pool(torch, tgt, seed: int) -> dict:
    """(f) ``ContinuousBatcher(max_batch=4, spec=SpecConfig("lookup"))`` and an
    oracle pool on 4 random 350-token prompts plus one admitted mid-stream,
    each stream against single-stream; then a compaction with holes on an
    engine capped at 1,024 slots (the same weights)."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams, SpecConfig
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    bos = tgt.tokenizer.bos_id
    prompts = [random_ids(torch, seed + 40 + i, 349, bos) for i in range(5)]
    lengths = [24, 48, 48, 48, 32]
    refs = [tgt.generate_ids(p, SamplingParams(max_new_tokens=m, ignore_eos=True)).token_ids
            for p, m in zip(prompts, lengths)]
    by_ids = {tuple(p): r for p, r in zip(prompts, refs)}
    out = {}
    for label, cfg in (("lookup", SpecConfig(kind="lookup", k=SPEC_K)),
                       ("oracle", SpecConfig(kind="oracle", k=SPEC_K, adaptive=False,
                                             governor=False,
                                             oracle=lambda ids: by_ids.get(tuple(ids), [])))):
        b = ContinuousBatcher(tgt, max_batch=4, spec=cfg)
        t0 = time.monotonic()
        try:
            futs = [b.submit_ids(p, SamplingParams(max_new_tokens=m, ignore_eos=True))
                    for p, m in zip(prompts[:4], lengths[:4])]
            first = futs[0].result(timeout=600)
            late = b.submit_ids(prompts[4], SamplingParams(max_new_tokens=lengths[4],
                                                           ignore_eos=True))
            results = [first] + [f.result(timeout=600) for f in futs[1:]] + [
                late.result(timeout=600)]
            snap, stats = b.spec_snapshot(), b.snapshot()
        finally:
            b.close()
        wall = time.monotonic() - t0
        checks = [greedy_check(torch, tgt, f"(f) {label} pool stream {i}", p, r.token_ids, ref)
                  for i, (p, r, ref) in enumerate(zip(prompts, results, refs))]
        out[label] = {"snapshot": snap, "admitted": stats["admitted"], "wall_s": wall,
                      "checks": checks}
        log(f"(f) {label} pool: {snap['rounds']} rounds, mean accepted {snap['mean_accepted']}, "
            f"governor {snap['governor']}, {stats['admitted']} admitted, {wall:.2f} s")
        if snap["rounds"] <= 0 or stats["admitted"] != 5:
            raise AssertionError(f"(f) {label}: {snap} {stats}")
    # The oracle forced to accept 1 a round: k holes a round, so the 160-token
    # stream's window (349 + 5 x 160 slots) crosses the 1,024-slot cap.
    capped = Engine(tgt.cfg, tgt.params, device=tgt.device, max_seq=1024,
                    stream_interval=tgt.stream_interval)
    pair = prompts[:2]
    lens = [32, 160]
    refs = [capped.generate_ids(p, SamplingParams(max_new_tokens=m, ignore_eos=True)).token_ids
            for p, m in zip(pair, lens)]
    cont = {tuple(p): r for p, r in zip(pair, refs)}
    b = ContinuousBatcher(capped, max_batch=4,
                          spec=SpecConfig(kind="oracle", k=SPEC_K, adaptive=False,
                                          governor=False, oracle_accept=1,
                                          oracle=lambda ids: cont.get(tuple(ids), [])))
    try:
        futs = [b.submit_ids(p, SamplingParams(max_new_tokens=m, ignore_eos=True))
                for p, m in zip(pair, lens)]
        results = [f.result(timeout=600) for f in futs]
        stats = b.snapshot()
    finally:
        b.close()
    checks = [greedy_check(torch, capped, f"(f) compaction stream {i}", p, r.token_ids, ref)
              for i, (p, r, ref) in enumerate(zip(pair, results, refs))]
    out["compaction"] = {"compactions": stats["compactions"], "checks": checks}
    log(f"(f) compaction with holes at 1,024 slots: {stats['compactions']} compactions, both "
        f"streams at full length")
    if stats["compactions"] < 1:
        raise AssertionError(f"(f) no compaction: {stats}")
    del capped
    return out


def spec_cli(torch, fa, da) -> dict:
    """(g) the slice's CLI with ``--draft llama-3-8b=llama-3.2-1b --spec-k 4``
    (``SPEC_CLI_TOKENS`` a model) and the batched slice's with
    ``LLMC_MAX_BATCH=4 --draft lookup``, both
    ``--events``: result.json's keys those of a plain run, metrics.json's
    ``spec`` block, consensus-1b plain."""
    out = {}
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    fresh_planes()
    sl = run_slice(torch, counters, {}, "(g) drafted slice", events=True, timing=False,
                   max_tokens=SPEC_CLI_TOKENS,
                   extra=("--draft", f"{SPEC_TARGET}={SPEC_DRAFT}", "--spec-k", str(SPEC_K)))
    doc, metrics = sl["doc"], sl["files"]["metrics.json"]
    spec = metrics.get("spec", {})
    by_model = {r["model"]: r for r in doc["responses"]}
    if (set(spec) != {SPEC_TARGET} or spec[SPEC_TARGET]["rounds"] <= 0
            or "spec" in by_model["gpu:consensus-1b"] or "spec" not in by_model["gpu:llama-3-8b"]):
        raise AssertionError(f"(g) drafted slice: spec {spec}, responses {doc['responses']}")
    out["drafted"] = {"wall_s": sl["wall_s"], "spec": spec, "launches": sl["launches"],
                      "keys": list(doc)}
    fresh_planes()
    release_memory(torch)
    bsl = run_slice(torch, counters, {"LLMC_MAX_BATCH": "4"}, "(g) batched lookup slice",
                    models=",".join(["gpu:llama-3-8b"] * 4), events=True, timing=False,
                    extra=("--draft", "lookup"))
    spec_b = bsl["files"]["metrics.json"].get("spec", {})
    if set(spec_b) != {SPEC_TARGET} or spec_b[SPEC_TARGET]["kind"] != "lookup":
        raise AssertionError(f"(g) batched lookup slice: spec {spec_b}")
    if list(bsl["doc"]) != list(doc):
        raise AssertionError(f"(g) result.json keys {list(bsl['doc'])} vs {list(doc)}")
    out["batched"] = {"wall_s": bsl["wall_s"], "spec": spec_b, "launches": bsl["launches"]}
    log(f"(g) CLI: drafted slice {sl['wall_s']:.2f} s (spec {spec}); batched lookup slice "
        f"{bsl['wall_s']:.2f} s (spec {spec_b})")
    fresh_planes()
    release_memory(torch)
    return out


def run_spec(torch, fa, da, card: str, seed: int, recs: dict) -> dict:
    """Phase 8g: speculative decoding on llama-3-8b bf16 drafted by
    llama-3.2-1b bf16, both at full width (random weights from the seed),
    8,192 slots each: (a)-(g) above. A "speculative decoding disabled"
    warning or any RuntimeWarning fails it. Prints a ``{"spec": ...}`` line."""
    import warnings

    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.models import get_config

    t_phase = time.monotonic()
    fresh_planes()
    release_memory(torch)
    _TEACHER.clear()
    torch.cuda.reset_peak_memory_stats()
    rows, part_s = {}, {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = time.monotonic()
        tgt = Engine(get_config(SPEC_TARGET), device=torch.device("cuda"), seed=seed)
        drf = Engine(get_config(SPEC_DRAFT), device=torch.device("cuda"), seed=seed + 1,
                     max_seq=tgt.max_seq)
        part_s["build"] = time.monotonic() - t
        ids = ByteTokenizer().encode(PROMPT)
        plain = tgt.generate(PROMPT, SamplingParams(max_new_tokens=SPEC_TOKENS, ignore_eos=True))
        for name, fn in (("a", lambda: spec_model_draft(torch, fa, da, tgt, drf, ids, plain)),
                         ("b", lambda: spec_oracle_sweep(torch, tgt, ids, plain)),
                         ("c", lambda: spec_lookup(torch, tgt, plain)),
                         ("d", lambda: spec_governor(torch, tgt, drf, ids)),
                         ("e", lambda: spec_sampled_and_fault(torch, tgt, drf, ids, plain)),
                         ("f", lambda: spec_pool(torch, tgt, seed))):
            t = time.monotonic()
            rows[name] = fn()
            part_s[name] = time.monotonic() - t
        recs["flash"]["launches"] = rows["a"]["flash"] - tgt.cfg.n_layers
        recs["decode"]["launches"] = rows["a"]["decode"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        del tgt, drf, plain
        release_memory(torch)
        t = time.monotonic()
        rows["g"] = spec_cli(torch, fa, da)
        part_s["g"] = time.monotonic() - t
    problems = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if problems:
        raise AssertionError(f"spec phase warnings: {problems}")
    phase_s = time.monotonic() - t_phase
    log(f"spec phase: {phase_s:.1f} s, parts {', '.join(f'{k} {v:.1f} s' for k, v in part_s.items())}"
        f", peak {peak:.2f} GB before the CLI parts")
    line = {"spec": {"card": card, "phase_s": phase_s, "part_s": part_s, "peak_gb": peak,
                     **rows}}
    print(json.dumps(line, default=str), flush=True)
    return line


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


# -- phase 8h: the serve gateway -------------------------------------------------

GATEWAY_ARGS = ["--models", "gpu:llama-3-8b,gpu:consensus-1b", "--judge", "gpu:llama-3-8b",
                "--max-batch", "8", "--queue-depth", "4", "--max-tokens", "48", "--port", "0"]
# Operator knobs of (d): the governor samples every 50 ms and climbs one rung
# a sample past the high-water mark; brownout serves the judge from
# consensus-1b. Read by `serve` once, at start.
GATEWAY_ENV = {"LLMC_PRESSURE_POLL_S": "0.05", "LLMC_PRESSURE_UP_PATIENCE": "1",
               "LLMC_PRESSURE_DOWN_PATIENCE": "2",
               "LLMC_PRESSURE_JUDGE_FALLBACK": "gpu:llama-3-8b=gpu:consensus-1b"}
# The shared prefix of (b)'s second wave: ~400 tokens of one system-style
# preamble ahead of four distinct questions.
SHARED_PREAMBLE = ("You are one member of a review panel. Read the question, weigh the "
                   "trade-offs a careful engineer would weigh, and answer in a few plain "
                   "sentences with one recommendation. ") * 2 + PROMPT[:60] + " "


def gw_post(port: int, body: dict, path: str = "/v1/consensus", timeout: float = 300.0):
    """One HTTP POST to the gateway on 127.0.0.1: (status, headers, body
    bytes, wall s, SSE events or None)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.monotonic()
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        headers = dict(r.getheaders())
        if headers.get("Content-Type") != "text/event-stream":
            return r.status, headers, r.read(), time.monotonic() - t0, None
        events, name, first = [], None, None
        for raw in r:
            line = raw.decode("utf-8").rstrip("\r\n")
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                if first is None:
                    first = time.monotonic() - t0
                events.append((name, json.loads(line[len("data: "):])))
        return r.status, headers, b"", time.monotonic() - t0, (events, first)
    finally:
        conn.close()


def gw_get(port: int, path: str) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode("utf-8")
    finally:
        conn.close()


def gw_fire(port: int, bodies: list) -> list:
    """``bodies`` POSTed concurrently; the answers in order."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = gw_post(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(o is None for o in out):
        raise AssertionError("gateway: a request never answered")
    return out


class StreamLog:
    """Every batcher submission of the phase, by wrapping
    ``ContinuousBatcher.submit_ids`` (a plain submit goes through it;
    restored on exit): a ``Submitted`` each. A journaled provider's stream
    carries its trace in its journal entry."""

    def __init__(self):
        from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

        self.cls, self.real = ContinuousBatcher, ContinuousBatcher.submit_ids
        self.items: list = []
        self.lock = threading.Lock()

    def __enter__(self):
        real, log_ = self.real, self

        def submit_ids(b, prompt_ids, *a, **kw):
            fut = real(b, prompt_ids, *a, **kw)
            jentry = kw.get("jentry")
            trace = kw.get("trace_id") or (jentry.trace if jentry is not None else None)
            with log_.lock:
                log_.items.append(Submitted(b.engine, list(prompt_ids),
                                            a[0] if a else kw.get("sampling"),
                                            list(kw.get("replay_ids") or ()), trace, fut))
            return fut

        self.cls.submit_ids = submit_ids
        return self

    def __exit__(self, *exc):
        self.cls.submit_ids = self.real

    def of(self, preset: str, needle: str) -> list:
        """The ``preset`` streams whose prompt holds ``needle``."""
        with self.lock:
            return [it for it in self.items if it.engine.cfg.name == preset
                    and needle in it.engine.tokenizer.decode(it.prompt_ids)]

    def traced(self, engine, trace: str) -> list:
        """``engine``'s streams that carry ``trace``."""
        with self.lock:
            return [it for it in self.items if it.engine is engine and it.trace == trace]


Submitted = collections.namedtuple(
    "Submitted", "engine prompt_ids sampling replay_ids trace future")


class RungLog:
    """The governor's rung after every sample that changed it (wraps
    ``PressureGovernor.observe``; restored on exit)."""

    def __init__(self):
        from llm_consensus_tpu_torch.pressure.governor import PressureGovernor

        self.cls, self.real = PressureGovernor, PressureGovernor.observe
        self.timeline: list = []
        self.t0 = time.monotonic()

    def __enter__(self):
        real, log_ = self.real, self

        def observe(g, pressure):
            before = g.state
            after = real(g, pressure)
            if after != before:
                log_.timeline.append((round(time.monotonic() - log_.t0, 3), after))
            return after

        self.cls.observe = observe
        return self

    def __exit__(self, *exc):
        self.cls.observe = self.real


def gw_doc(answer, label: str) -> dict:
    status, _h, data, _wall, _sse = answer
    if status != 200:
        raise AssertionError(f"gateway {label}: status {status}: {data[:500]!r}")
    doc = json.loads(data)
    if (len(doc["responses"]) != 2 or doc.get("failed_models") or not doc["consensus"]
            or {r["model"] for r in doc["responses"]} != {"gpu:llama-3-8b", "gpu:consensus-1b"}):
        raise AssertionError(f"gateway {label}: {json.dumps(doc)[:800]}")
    return doc


SERVE_FILES = ["consensus.md", "prompt.txt", "result.json", "run.json"]
RESULT_KEYS = ["prompt", "responses", "consensus", "judge", "agreement"]


def gw_run_dir(data_dir: str, doc: dict, label: str) -> None:
    """A served run's directory: the one-shot CLI's result files (no
    ``panel/`` journal and no ``metrics.json`` without ``--events``, as in the
    JAX server), ``result.json`` with the CLI's keys in its order."""
    got = read_run_dir(os.path.join(data_dir, doc["run_id"]))
    keys = [k for k in got.get("result.json", {}) if k in RESULT_KEYS]
    if got["listing"] != SERVE_FILES or keys != RESULT_KEYS or \
            got["result.json"]["consensus"] != doc["consensus"]:
        raise AssertionError(f"gateway {label}: run dir {got['listing']}, keys {keys}")


def gw_stream_check(torch, log_: StreamLog, engine, preset: str, needle: str,
                    label: str) -> dict:
    """The batched ``preset`` stream of the request holding ``needle``,
    held by the near-tie rule to ``engine``'s single-stream greedy tokens."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    items = log_.of(preset, needle)
    if len(items) != 1:
        raise AssertionError(f"gateway {label}: {len(items)} {preset} streams for {needle!r}")
    item = items[0]
    sampling = item.sampling
    got = item.future.result(timeout=60).token_ids
    ids = engine._budget_prompt(item.prompt_ids, sampling.max_new_tokens)[0]
    ref = engine.generate_ids(ids, SamplingParams(max_new_tokens=sampling.max_new_tokens,
                                                  ignore_eos=sampling.ignore_eos)).token_ids
    return greedy_check(torch, engine, f"gateway {label}", ids, got, ref)


def latency_by_kind(lat: dict) -> dict:
    """Each request kind's count, median and maximum latency (s)."""
    return {kind: {"n": len(xs), "p50_s": statistics.median(xs), "max_s": max(xs)}
            for kind, xs in lat.items() if xs}


def gw_calm(port: int) -> None:
    """Wait for the governor to walk back to ``ok`` (an escalated ladder
    would brown out, and so re-key, the next requests)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if json.loads(gw_get(port, "/statsz")[1])["pressure"]["state"] == "ok":
            return
        time.sleep(0.05)
    raise AssertionError("gateway: the governor never walked back to ok")


def gw_metrics(port: int) -> dict:
    """/metricsz parsed (the port's Prometheus parser)."""
    from llm_consensus_tpu_torch.obs import prom

    status, text = gw_get(port, "/metricsz")
    if status != 200:
        raise AssertionError(f"gateway /metricsz: {status}")
    return prom.parse_text(text)


def gw_hist(parsed: dict, metric: str) -> tuple:
    """(count, sum) of one histogram family over every label set."""
    hs = [h for (m, _), h in parsed["histograms"].items() if m == metric]
    return sum(h["count"] for h in hs), sum(h["sum"] for h in hs)


def hf_tensors_from_params(cfg, params: dict) -> dict:
    """A dense bf16 parameter tree in the HF layout (the inverse of the
    loader's: [in, out] matmul weights back to [out, in], one tensor per
    layer), on the host."""
    from llm_consensus_tpu_torch.engine.checkpoint import _HF_LAYER_MAP, _HF_TRANSPOSE

    t = {"model.embed_tokens.weight": params["embed"].cpu(),
         "model.norm.weight": params["final_norm"].cpu()}
    if "lm_head" in params:
        t["lm_head.weight"] = params["lm_head"].t().contiguous().cpu()
    for name, stacked in params["layers"].items():
        for i in range(cfg.n_layers):
            w = stacked[i]
            t[_HF_LAYER_MAP[name].format(i=i)] = (
                w.t() if _HF_TRANSPOSE[name] else w).contiguous().cpu()
    return t


@contextlib.contextmanager
def gw_reference(ports: list, counters: dict, tally: dict, label: str = "gateway"):
    """A block of reference runs on the card (single-stream generates,
    teacher forcing, runs sent to a replica directly) with no served
    request in flight on any of ``ports``: the launches it makes go into
    ``tally``, which the phase subtracts from its counts, so that these
    count only the served traffic's. A request that just answered may hold
    its admission slot a moment longer; one still held after 30 s fails."""
    def idle(when, wait_s):
        deadline = time.monotonic() + wait_s
        for port in ports:
            while True:
                adm = json.loads(gw_get(port, "/statsz")[1])["admission"]
                if not (adm["active"] or adm["waiting"]):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: served traffic in flight {when} a "
                                         f"reference run: {adm}")
                time.sleep(0.01)

    idle("before", 30.0)
    before = {name: c.count for name, c in counters.items()}
    yield
    for name, c in counters.items():
        tally[name] += c.count - before[name]
    idle("after", 0.0)


def gateway_swap(torch, port: int, log_: StreamLog, seed: int, tmp: str,
                 answered: list, lat: dict, counters: dict, tally: dict) -> dict:
    """(e) consensus-1b swapped to seed + 1 weights (an HF safetensors
    directory written from ``init_params`` at seed + 1, so its logits have
    the scale of the served random weights the near-tie rule is set for)
    while a request decodes, then rolled back. The reference runs go
    through ``gw_reference`` (their launches into ``tally``)."""
    from llm_consensus_tpu_torch.engine import Engine
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params

    cfg = get_config("consensus-1b")
    ckpt = os.path.join(tmp, "consensus-1b-seed1")
    os.makedirs(ckpt)
    t0 = time.monotonic()
    new = init_params(cfg, seed + 1, device=torch.device("cuda"))
    write_safetensors(os.path.join(ckpt, "model.safetensors"), hf_tensors_from_params(cfg, new))
    del new
    release_memory(torch)
    write_s = time.monotonic() - t0
    engine = log_.of("consensus-1b", "")[0].engine  # the served engine
    mem = {"before": torch.cuda.memory_allocated() / 1e9}
    inflight = []
    body = {"prompt": "Swap request one. " + PROMPT, "max_tokens": 48}
    t = threading.Thread(target=lambda: inflight.append(gw_post(port, body)), daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and engine.swap_stats()["pins"] == 0:
        time.sleep(0.002)
    if engine.swap_stats()["pins"] == 0:
        raise AssertionError("gateway (e): the request never pinned consensus-1b")
    t_swap = time.monotonic()
    status, _h, data, _w, _s = gw_post(port, {"model": "gpu:consensus-1b", "checkpoint": ckpt},
                                       path="/v1/swap")
    swap_doc = json.loads(data)
    post_s = time.monotonic() - t_swap
    parked = bool(swap_doc.get("swap_pending"))
    mem["during"] = torch.cuda.memory_allocated() / 1e9
    t.join(600)
    answered.append(gw_doc(inflight[0], "(e) in flight"))
    lat.setdefault("e_in_flight_48", []).append(inflight[0][3])
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and engine.weight_version < 1:
        time.sleep(0.01)
    stats = engine.swap_stats()
    mem["after_flip"] = torch.cuda.memory_allocated() / 1e9
    if status != 200 or not swap_doc.get("accepted") or engine.weight_version != 1:
        raise AssertionError(f"gateway (e): swap {status} {swap_doc}, version "
                             f"{engine.weight_version}")
    # The next request on the new weights, against a fresh engine on them.
    two = gw_post(port, {"prompt": "Swap request two. " + PROMPT, "max_tokens": 16})
    answered.append(gw_doc(two, "(e) after the flip"))
    with gw_reference([port], counters, tally):
        fresh = Engine(cfg, try_load_params(cfg, ckpt, device=torch.device("cuda")))
        new_row = gw_stream_check(torch, log_, fresh, "consensus-1b", "Swap request two.",
                                  "(e) v1 stream against a fresh engine on the seed + 1 weights")
        del fresh
        release_memory(torch)
    status, _h, data, _w, _s = gw_post(
        port, {"model": "gpu:consensus-1b", "action": "rollback"}, path="/v1/swap")
    rollback = json.loads(data)
    if status != 200 or rollback.get("weight_version") != 2 or engine.weight_version != 2:
        raise AssertionError(f"gateway (e): rollback {status} {rollback}")
    mem["after_rollback"] = torch.cuda.memory_allocated() / 1e9
    three = gw_post(port, {"prompt": "Swap request three. " + PROMPT, "max_tokens": 16})
    answered.append(gw_doc(three, "(e) after the rollback"))
    lat.setdefault("e_16", []).extend([two[3], three[3]])
    # v0 again: the in-flight stream and the post-rollback one, each against
    # the served engine's own single-stream tokens on the v0 weights.
    with gw_reference([port], counters, tally):
        old_row = gw_stream_check(torch, log_, engine, "consensus-1b", "Swap request one.",
                                  "(e) in-flight stream on v0")
        back_row = gw_stream_check(torch, log_, engine, "consensus-1b", "Swap request three.",
                                   "(e) v2 (rolled back) stream on v0")
    out = {"write_s": write_s, "post_s": post_s, "parked": parked,
           "prep_ms": stats["last_prep_ms"], "vacate_ms": stats["last_vacate_ms"],
           "swaps": engine.swap_stats()["swaps"], "rollbacks": engine.swap_stats()["rollbacks"],
           "memory_gb": mem, "streams": {"v0_in_flight": old_row, "v1": new_row,
                                         "v2": back_row}}
    log(f"gateway (e): checkpoint written in {write_s:.1f} s; swap POST {post_s:.2f} s, parked "
        f"under the in-flight pin {parked}, prep {stats['last_prep_ms']:.1f} ms, vacate "
        f"{stats['last_vacate_ms']:.1f} ms; memory GB {mem}; streams v0 {old_row['equal']}, "
        f"v1 {new_row['equal']}, v2 {back_row['equal']} (equal or within the near-tie rule)")
    return out


def gateway_child(tmp: str) -> dict:
    """(f) ``python -m llm_consensus_tpu_torch serve`` in a child process
    (consensus-1b panel and judge), one request in flight, SIGTERM: exit 0
    and the run flushed."""
    import signal

    data = os.path.join(tmp, "child-data")
    argv = [sys.executable, "-m", "llm_consensus_tpu_torch", "serve", "--models",
            "gpu:consensus-1b", "--judge", "gpu:consensus-1b", "--max-tokens", "48",
            "--port", "0", "--data-dir", data]
    t0 = time.monotonic()
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=os.getcwd()))
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                              daemon=True)
    reader.start()
    try:
        port = None
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and port is None:
            for line in list(lines):
                if "http://" in line:
                    port = int(line.split("http://", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
            if proc.poll() is not None:
                raise AssertionError(f"gateway (f): child exited {proc.returncode}: {lines}")
            time.sleep(0.05)
        if port is None:
            raise AssertionError(f"gateway (f): child never listened: {lines}")
        up_s = time.monotonic() - t0
        answer = []
        t = threading.Thread(target=lambda: answer.append(gw_post(
            port, {"prompt": "A request the child drains. " + PROMPT})), daemon=True)
        t.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if json.loads(gw_get(port, "/statsz")[1])["admission"]["active"] >= 1:
                break
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        t.join(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    status, _h, body, wall, _s = answer[0]
    doc = json.loads(body)
    flushed = read_run_dir(os.path.join(data, doc["run_id"]))
    if rc != 0 or status != 200 or flushed["listing"] != SERVE_FILES:
        raise AssertionError(f"gateway (f) child: rc {rc}, status {status}, {flushed['listing']}"
                             f", stderr {lines[-5:]}")
    log(f"gateway (f) child: up in {up_s:.1f} s, its request {wall:.2f} s, SIGTERM drained "
        f"to exit 0, run flushed")
    return {"up_s": up_s, "request_s": wall, "rc": rc}


def run_gateway(torch, fa, da, card: str, seed: int) -> dict:
    """Phase 8h: the ``serve`` subcommand in process (``cli.main(["serve",
    ...])`` on a thread, stopped by its shutdown event) over llama-3-8b and
    consensus-1b (bf16, full width, random weights), real HTTP on 127.0.0.1:
    (a) 8 concurrent distinct requests, 4 running and 4 queued; (b) 4
    identical ones (one run, 3 coalesced) and a cache hit, then 4 distinct
    questions behind one shared preamble; (c) an SSE request; (d) a burst of
    12 LOW requests with a HIGH one inside it under the knobs of
    ``GATEWAY_ENV``; (e) the weight swap and rollback; (f) a drain with two
    requests in flight, then a child server drained by SIGTERM. Prints a
    ``{"gateway": ...}`` line."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main

    t_phase = time.monotonic()
    fresh_planes()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-gateway-")
    data = os.path.join(tmp, "data")
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    reference = dict.fromkeys(counters, 0)  # launches of (e)'s reference runs
    stop = threading.Event()
    err = io.StringIO()
    rc: list = []
    answered: list = []  # every 200 answer's doc, for the TTFT count
    out: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    with set_environ(GATEWAY_ENV), StreamLog() as slog, RungLog() as rungs:
        server = threading.Thread(target=lambda: rc.append(cli_main(
            ["serve", *GATEWAY_ARGS, "--data-dir", data], device=None, stdout=io.StringIO(),
            stderr=err, install_signal_handlers=False, shutdown=stop)), daemon=True)
        server.start()
        try:
            port = None
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and port is None and server.is_alive():
                text = err.getvalue()
                if "http://" in text:
                    port = int(text.split("http://", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
                time.sleep(0.01)
            if port is None:
                raise AssertionError(f"gateway: the server never listened: {err.getvalue()}")
            log(f"gateway: serving on 127.0.0.1:{port} after {time.monotonic() - t_phase:.1f} s")
            lat: dict = {}  # request kind → latencies (s, host clock)

            # (a) 8 distinct concurrent requests: 4 run, 4 queue.
            t0 = time.monotonic()
            peak_q = [0]
            watch = threading.Event()

            def watch_queue():
                while not watch.is_set():
                    try:
                        adm = json.loads(gw_get(port, "/statsz")[1])["admission"]
                        peak_q[0] = max(peak_q[0], adm["waiting"])
                    except Exception:  # noqa: BLE001 — a probe, not a check
                        pass
                    time.sleep(0.02)

            w = threading.Thread(target=watch_queue, daemon=True)
            w.start()
            first = gw_fire(port, [{"prompt": f"Request {i} of eight. " + PROMPT,
                                    "max_tokens": 16} for i in range(8)])
            watch.set()
            w.join(10)
            for i, a in enumerate(first):
                doc = gw_doc(a, f"(a) request {i}")
                gw_run_dir(data, doc, f"(a) request {i}")
                answered.append(doc)
                lat.setdefault("a_16", []).append(a[3])
            out["a"] = {"wall_s": time.monotonic() - t0, "peak_queued": peak_q[0],
                        "latencies_s": [a[3] for a in first]}
            if peak_q[0] < 3:
                raise AssertionError(f"gateway (a): the queue held at most {peak_q[0]}")
            log(f"gateway (a): 8 answers in {out['a']['wall_s']:.2f} s, peak queue {peak_q[0]}")

            # (b) 4 identical (one run, 3 followers), then a cache hit; then
            # 4 questions behind one shared preamble.
            gw_calm(port)
            t0 = time.monotonic()
            runs0 = json.loads(gw_get(port, "/statsz")[1])["runs_executed"]
            same = gw_fire(port, [{"prompt": "Coalesce me. " + PROMPT, "max_tokens": 16}] * 4)
            docs = [gw_doc(a, "(b) identical") for a in same]
            hit = gw_doc(gw_post(port, {"prompt": "Coalesce me. " + PROMPT, "max_tokens": 16}),
                         "(b) cache hit")
            runs1 = json.loads(gw_get(port, "/statsz")[1])["runs_executed"]
            ids = {d["run_id"] for d in docs + [hit]}
            coalesced = sum(d["coalesced"] for d in docs)
            for d in docs + [hit]:
                gw_run_dir(data, d, "(b)")
            answered += docs + [hit]
            lat["b_identical_16"] = [a[3] for a in same]
            if runs1 - runs0 != 1 or coalesced != 3 or not hit["cached"] or len(ids) != 5:
                raise AssertionError(f"gateway (b): runs {runs1 - runs0}, coalesced {coalesced}, "
                                     f"cached {hit['cached']}, run ids {len(ids)}")
            state0 = da.LAUNCHES_STATE.count
            shared = gw_fire(port, [{"prompt": SHARED_PREAMBLE + f"Question {i}: which option "
                                     "and why?", "max_tokens": 16} for i in range(4)])
            for a in shared:
                answered.append(gw_doc(a, "(b) shared preamble"))
                lat.setdefault("b_shared_16", []).append(a[3])
            out["b"] = {"wall_s": time.monotonic() - t0, "coalesced": coalesced,
                        "cached": 1, "state_launches": da.LAUNCHES_STATE.count - state0,
                        "prefix_len": json.loads(gw_get(port, "/statsz")[1])[
                            "batchers"]["llama-3-8b"]["prefix_len"]}
            log(f"gateway (b): one run for 4 identical requests (3 coalesced), a cache hit, "
                f"5 run dirs; shared-preamble wave: {out['b']['state_launches']} return_state "
                f"launches, prefix {out['b']['prefix_len']} tokens")

            # (c) SSE: chunks from both panel models and the judge, then done.
            status, headers, _b, wall, (events, ttft) = gw_post(
                port, {"prompt": "Stream this one. " + PROMPT, "stream": True, "max_tokens": 16})
            kinds = {(d["kind"], d["model"]) for n, d in events if n == "chunk"}
            done = [d for n, d in events if n == "done"]
            if (status != 200 or headers.get("Content-Type") != "text/event-stream" or not done
                    or events[-1][0] != "done"
                    or not {("model_chunk", "gpu:llama-3-8b"), ("model_chunk", "gpu:consensus-1b"),
                            ("judge_chunk", "gpu:llama-3-8b")} <= kinds):
                raise AssertionError(f"gateway (c): {status} {kinds} {[n for n, _ in events]}")
            answered.append(done[0])
            lat["c_sse_16"] = [wall]
            out["c"] = {"ttft_s": ttft, "wall_s": wall, "chunks": len(events) - 1}
            log(f"gateway (c): SSE {len(events) - 1} chunks, first after {ttft:.3f} s, done after "
                f"{wall:.2f} s")

            # (d) overload: 12 LOW requests beyond the queue, a HIGH one
            # inside the burst.
            t0 = time.monotonic()
            burst: list = [None] * 12
            high: list = []

            def low(i):
                burst[i] = gw_post(port, {"prompt": f"Flood {i}. " + PROMPT, "priority": "low",
                                          "max_tokens": 16})

            threads = [threading.Thread(target=low, args=(i,), daemon=True) for i in range(12)]
            for th in threads:
                th.start()
            time.sleep(0.3)
            hi = threading.Thread(target=lambda: high.append(gw_post(
                port, {"prompt": "An urgent question. " + PROMPT, "priority": "high",
                       "max_tokens": 16})),
                daemon=True)
            hi.start()
            for th in threads + [hi]:
                th.join(600)
            shed = [a for a in burst if a[0] in (429, 503)]
            served = [a for a in burst if a[0] == 200]
            ras = [float(json.loads(a[2])["retry_after_s"]) for a in shed]
            heads = [a[1].get("Retry-After") for a in shed]
            for a in served:
                answered.append(json.loads(a[2]))
            answered.append(gw_doc(high[0], "(d) HIGH in the burst"))
            lat["d_low_served_16"] = [a[3] for a in served]
            lat["d_high_16"] = [high[0][3]]
            deg = [json.loads(a[2]).get("degraded") for a in served]
            if (not shed or len(shed) + len(served) != 12 or any(h is None for h in heads)
                    or not all(1.5 <= r < 3.0 for r in ras)
                    or not any(s != "ok" for _t, s in rungs.timeline)):
                raise AssertionError(f"gateway (d): shed {len(shed)}, served {len(served)}, "
                                     f"Retry-After {ras} {heads}, rungs {rungs.timeline}")
            for path in ("/healthz", "/statsz", "/metricsz"):
                s, text = gw_get(port, path)
                if s != 200 or (path != "/metricsz" and not json.loads(text)):
                    raise AssertionError(f"gateway (d): {path} {s}")
            gw_calm(port)
            out["d"] = {"wall_s": time.monotonic() - t0, "shed": len(shed),
                        "served": len(served), "retry_after_s": ras, "degraded": deg,
                        "high_s": high[0][3], "rungs": list(rungs.timeline)}
            log(f"gateway (d): {len(shed)} of 12 LOW shed (Retry-After {min(ras):.2f}-"
                f"{max(ras):.2f} s), {len(served)} served ({deg.count('brownout')} browned "
                f"out), HIGH answered in {high[0][3]:.2f} s; rungs {rungs.timeline}")

            # (e) the swap.
            out["e"] = gateway_swap(torch, port, slog, seed, tmp, answered, lat, counters,
                                    reference)

            # TTFT count against every answered request, and queue wait.
            parsed = gw_metrics(port)
            ttft_n, _ = gw_hist(parsed, "ttft")
            qn, qsum = gw_hist(parsed, "queue_wait")
            if ttft_n != len(answered):
                raise AssertionError(f"gateway: TTFT count {ttft_n} against {len(answered)} "
                                     f"answered")
            out["queue_wait_mean_s"] = qsum / qn if qn else None

            # (f) drain with 2 requests in flight.
            pair: list = []
            ths = [threading.Thread(target=lambda i=i: pair.append(gw_post(
                port, {"prompt": f"Drain request {i}. " + PROMPT, "max_tokens": 16})),
                daemon=True)
                for i in range(2)]
            for th in ths:
                th.start()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if json.loads(gw_get(port, "/statsz")[1])["admission"]["active"] >= 2:
                    break
                time.sleep(0.01)
            t_drain = time.monotonic()
            stop.set()
            server.join(300)
            drain_s = time.monotonic() - t_drain
            for th in ths:
                th.join(60)
            for a in pair:
                gw_run_dir(data, gw_doc(a, "(f) drained"), "(f) drained")
            lat["f_drained_16"] = [a[3] for a in pair]
            if rc != [0]:
                raise AssertionError(f"gateway (f): serve returned {rc}: {err.getvalue()[-800:]}")
        finally:
            stop.set()
            server.join(300)
    # The served traffic's launches: the counts less (e)'s reference runs.
    launches = {name: c.count - reference[name] for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["f"] = {"drain_s": drain_s, "child": gateway_child(tmp)}
    if launches["flash_attention"] <= 0 or launches["decode_attention"] <= 0:
        raise AssertionError(f"gateway: a kernel of the path never launched: {launches}")
    out.update({"latency_s": latency_by_kind(lat), "answered": len(answered),
                "launches": launches, "reference_launches": reference, "peak_gb": peak,
                "wall_s": time.monotonic() - t_phase})
    log(f"gateway: {len(answered)} answered, latency by kind {out['latency_s']}, queue wait "
        f"mean {out['queue_wait_mean_s']}, launches through the gateway {launches} (reference "
        f"runs {reference}, not counted), peak {peak:.2f} GB, phase {out['wall_s']:.1f} s")
    print(json.dumps({"gateway": out, "card": card}, default=str), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    release_memory(torch)
    return out


# -- phase 8i: the route slice ----------------------------------------------------

ROUTE_PANEL = ["gpu:llama-3-8b", "gpu:consensus-1b"]
ROUTE_JUDGE = "gpu:llama-3-8b"
# Each replica's engines at 2,048 slots (LLMC_MAX_SEQ, read through
# utils/knobs.py as the CLI reads it): a replica is ~20 GB (16.06 GB of
# llama-3-8b, 1.74 GB of consensus-1b, 0.27 GB of KV a 2,048-slot row), so
# two fit the card beside each other; the ~1,000-token judge prompt fits.
ROUTE_ENV = {"LLMC_MAX_SEQ": "2048"}
ROUTE_MAX_BATCH = 4
ROUTE_TOKENS = 16
ROUTE_MIGRATE_TOKENS = 48
ROUTE_DOWN_FRAME = 2  # (c): the router loses the home replica at this SSE frame


def route_sse(port: int, body: dict, trace: str, timeout: float = 300.0) -> dict:
    """One SSE POST on 127.0.0.1 with ``X-LLMC-Trace``: every event with its
    arrival time (s since the request), and the text by ``kind:model``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.monotonic()
    events: list = []
    try:
        conn.request("POST", "/v1/consensus", json.dumps(dict(body, stream=True)),
                     {"Content-Type": "application/json", "Accept": "text/event-stream",
                      "X-LLMC-Trace": trace})
        r = conn.getresponse()
        if r.status != 200:
            raise AssertionError(f"route: SSE status {r.status}: {r.read()[:300]!r}")
        name = None
        for raw in r:
            line = raw.decode("utf-8").rstrip("\r\n")
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                events.append((time.monotonic() - t0, name, json.loads(line[len("data: "):])))
    finally:
        conn.close()
    names = [n for _t, n, _d in events]
    if names.count("done") != 1 or names[-1] != "done" or "error" in names:
        raise AssertionError(f"route: SSE events {names}")
    text: dict = {}
    for _t, n, d in events:
        if n == "chunk":
            key = f"{d['kind']}:{d['model']}"
            text[key] = text.get(key, "") + d["text"]
    return {"events": events, "text": text, "done": events[-1][2], "t0": t0,
            "wall_s": time.monotonic() - t0}


def route_replica(torch, tag: str, tmp: str, settings: dict) -> dict:
    """One replica: its own ``GPUProvider`` (engines, batchers, a journal
    mirrored to ``wal-<tag>``), gateway, recorder and live plane (each bound
    at construction), the panel's engines and batchers built before any
    traffic. The governor is off: a busy pool reads as pressure 1.0 and
    would shed the fleet's own traffic (ROADMAP queue 3)."""
    from llm_consensus_tpu_torch import obs, serve
    from llm_consensus_tpu_torch.obs.live import LiveMetrics
    from llm_consensus_tpu_torch.providers import Registry
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider, parse_model_name
    from llm_consensus_tpu_torch.recovery import StreamJournal

    t0 = time.monotonic()
    rec, live = obs.Recorder(), LiveMetrics(window_s=3600.0)
    obs.install(rec)
    obs.live.install(live)
    wal = os.path.join(tmp, f"wal-{tag}")
    provider = GPUProvider(device=None, batch_streams=ROUTE_MAX_BATCH,
                           journal=StreamJournal(path=wal), **settings)
    registry = Registry()
    for m in dict.fromkeys(ROUTE_PANEL + [ROUTE_JUDGE]):
        registry.register(m, provider)
    provider.prepare(ROUTE_PANEL, ROUTE_JUDGE)
    for m in ROUTE_PANEL:
        provider._batcher_for(parse_model_name(m), provider._engine_for(m))
    gw = serve.build_gateway(registry, ROUTE_PANEL, ROUTE_JUDGE, max_tokens=ROUTE_TOKENS,
                             timeout=300.0, max_concurrency=2, max_queue=8, cache_size=0,
                             data_dir=os.path.join(tmp, f"data-{tag}"), save=False, live=live,
                             pressure={"enabled": False})
    host, port = gw.start()
    torch.cuda.synchronize()
    return {"gw": gw, "provider": provider, "rec": rec, "wal": wal, "port": port,
            "url": f"http://{host}:{port}", "build_s": time.monotonic() - t0,
            "engines": provider.engines()}


def route_runs(rep: dict) -> int:
    return json.loads(gw_get(rep["port"], "/statsz")[1])["runs_executed"]


def route_wait_runs(rep: dict, n: int, label: str) -> None:
    deadline = time.monotonic() + 300
    while route_runs(rep) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"route {label}: {rep['url']} never finished its run")
        time.sleep(0.05)


def route_spans(rec, name: str, trace: str) -> list:
    return [e for e in rec.events() if e.ph == "X" and e.name == name
            and e.args.get("trace") == trace]


def route_texts_match(torch, label: str, got: dict, ref: dict, slog: StreamLog, streams: list,
                      reps: dict) -> dict:
    """The client's text against the undisturbed reference: equal, or every
    differing model's incarnations within the near-tie rule under teacher
    forcing (their gaps printed)."""
    if got == ref:
        return {"equal": True}
    gaps: dict = {}
    for key in sorted(set(got) | set(ref)):
        if got.get(key) == ref.get(key):
            continue
        preset = key.split(":", 1)[1].split(":", 1)[-1]
        for tag, trace in streams:
            engine = reps[tag]["engines"][preset]
            for it in slog.traced(engine, trace):
                toks = it.future.result(timeout=60).token_ids
                g, _std = teacher_gaps(torch, engine, it.prompt_ids, toks)
                gaps[f"{key}@{tag}"] = max(g) if g else 0.0
    log(f"route {label}: text differs from the reference; teacher-forced largest gaps {gaps}, "
        f"tol {NEAR_TIE_TOL}")
    if not gaps or max(gaps.values()) > NEAR_TIE_TOL:
        raise AssertionError(f"route {label}: client text differs beyond a near-tie: "
                             f"{got} against {ref}; gaps {gaps}")
    return {"equal": False, "gaps": gaps}


def run_route(torch, fa, da, card: str, seed: int) -> dict:
    """Phase 8i: the route slice. Two replicas in this process, each a
    gateway over its own ``GPUProvider`` (never ``GPUProvider.shared``, whose
    key would give both one provider): its own engines, batchers and journal,
    so a migration's destination has never seen the stream. Each serves
    panel ``llama-3-8b`` + ``consensus-1b``, judge ``llama-3-8b``, bf16, full
    width, random weights from the seed (identical in both: what makes a
    failover byte-identical), ``LLMC_MAX_SEQ=2048`` (through
    ``utils/knobs.py``), 4 batcher rows, 16 tokens a request unless stated.
    One router from ``build_router([url_a, url_b])`` on 127.0.0.1, its health
    polls driven by hand, its spillover lane over the session phase's local
    SSE mock (no network). (a) 4 distinct requests homed 2 and 2 by the ring;
    (b) 3 identical ones: one run on their home, 2 coalesced; (c) one SSE
    request on an idle fleet whose home replica the router loses at frame 2
    (``replica_down``): the client's text equals an undisturbed run on the
    other replica, one ``done``; (d) a single-model SSE request (48 tokens)
    migrated by ``POST /v1/retire`` mid-decode: the record carries tokens,
    the destination resumes through ``replay_ids`` (flash on prompt + tokens)
    and the text equals its reference; (e) the router's ``/metricsz`` equals
    the bucket-wise merge of the replicas', ``/statsz`` holds the failovers
    and migrations, one trace id on the router's span, both replicas'
    ``engine_stream`` spans for (c) and the destination's journal for (d);
    (f) no replica placeable: a long-deadline request spills to the mock
    (``degraded: remote``), a tight one gets 503; (g) ``main(["route",
    ...])`` answers one request over replica b and exits 0. Flash and the
    bf16 decode kernel must launch through the routed traffic; the (c) and
    (d) reference runs and near-tie checks are counted apart. Prints a
    ``{"route": ...}`` line."""
    from llm_consensus_tpu_torch import faults, obs, serve
    from llm_consensus_tpu_torch.cli.main import main as cli_main
    from llm_consensus_tpu_torch.obs import prom
    from llm_consensus_tpu_torch.obs.live import LiveMetrics
    from llm_consensus_tpu_torch.providers.registry import remote_registry
    from llm_consensus_tpu_torch.recovery.journal import read_wal
    from llm_consensus_tpu_torch.serve import elastic as elastic_mod
    from llm_consensus_tpu_torch.serve.router import RouteRequest
    from llm_consensus_tpu_torch.utils import knobs

    t_phase = time.monotonic()
    fresh_planes()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-route-")
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    reference = dict.fromkeys(counters, 0)
    out: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps: dict = {}
    router = None
    shipped: list = []
    real_ship = elastic_mod.ship_record

    def ship(dest, record, timeout_s=10.0):
        shipped.append(record.to_doc())
        return real_ship(dest, record, timeout_s=timeout_s)

    with set_environ(ROUTE_ENV), openai_mock() as mock_bodies, StreamLog() as slog:
        settings = knobs.engine_settings()
        if settings["max_seq"] != 2048:
            raise AssertionError(f"route: LLMC_MAX_SEQ read as {settings}")
        elastic_mod.ship_record = ship
        try:
            for tag in ("a", "b"):
                torch.manual_seed(seed)
                reps[tag] = route_replica(torch, tag, tmp, settings)
            for tag, rep in reps.items():
                if {e.max_seq for e in rep["engines"].values()} != {2048}:
                    raise AssertionError(f"route: replica {tag} engines {rep['engines']}")
            out["build_s"] = {tag: rep["build_s"] for tag, rep in reps.items()}
            out["memory_gb_after_build"] = torch.cuda.memory_allocated() / 1e9
            log(f"route: replicas built in {out['build_s']} s, "
                f"{out['memory_gb_after_build']:.2f} GB allocated")
            url_a, url_b = reps["a"]["url"], reps["b"]["url"]
            rec_r = obs.Recorder()
            obs.install(rec_r)
            obs.live.install(LiveMetrics(window_s=3600.0))
            faults.install(faults.FaultPlan(f"replica_down@phase=proxy@frame={ROUTE_DOWN_FRAME}",
                                            seed=seed))
            router = serve.build_router(
                [url_a, url_b], poll_s=60.0,
                spillover_registry=remote_registry([REMOTE_MODEL], REMOTE_MODEL),
                spillover_models=[REMOTE_MODEL], spillover_judge=REMOTE_MODEL,
                data_dir=os.path.join(tmp, "spill"))
            faults.install(None)  # the router bound the plan; nothing else does
            rport = router.start()[1]

            def home(body: dict) -> str:
                return router.candidates(RouteRequest(b"", dict(body), False).key())[0]

            def homed(label: str, url: str, extra: dict = None) -> dict:
                for i in range(200):
                    body = dict(extra or {}, prompt=f"{label} {i}. " + PROMPT)
                    if home(body) == url:
                        return body
                raise AssertionError(f"route: no prompt homes on {url}")

            for c in counters.values():
                c.reset()

            # (a) placement: 4 distinct requests, 2 homed on each replica.
            t0 = time.monotonic()
            bodies = [homed(f"Routed request a{j}", url) for url in (url_a, url_b)
                      for j in range(2)]
            answers = gw_fire(rport, bodies)
            docs = [gw_doc(a, f"route (a) request {i}") for i, a in enumerate(answers)]
            placed = [d["replica"] for d in docs]
            if placed != [home(b) for b in bodies] or set(placed) != {url_a, url_b}:
                raise AssertionError(f"route (a): placed {placed}")
            stats = json.loads(gw_get(rport, "/statsz")[1])
            # Each request's client wall and its panel models' own latencies
            # (the rest of the wall is the judge and the queue), by replica.
            by_replica = {tag: [{"wall_s": a[3], "panel_s": {r["model"]: r["latency_ms"] / 1e3
                                                             for r in d["responses"]}}
                                for a, d in zip(answers, docs) if d["replica"] == rep["url"]]
                          for tag, rep in reps.items()}
            out["a"] = {"wall_s": time.monotonic() - t0, "latencies_s": [a[3] for a in answers],
                        "placed": {tag: placed.count(rep["url"]) for tag, rep in reps.items()},
                        "by_replica": by_replica, "requests": stats["counters"]["requests"]}
            log(f"route (a): 4 answers in {out['a']['wall_s']:.2f} s, placed {out['a']['placed']}; "
                f"by replica {by_replica}")

            # (b) fleet-wide coalescing: 3 identical requests, one run on their home.
            t0 = time.monotonic()
            body = {"prompt": "Coalesce across the fleet. " + PROMPT}
            runs0 = {tag: route_runs(rep) for tag, rep in reps.items()}
            same = [gw_doc(a, "route (b)") for a in gw_fire(rport, [body] * 3)]
            runs1 = {tag: route_runs(rep) for tag, rep in reps.items()}
            delta = {tag: runs1[tag] - runs0[tag] for tag in reps}
            home_tag = "a" if home(body) == url_a else "b"
            coalesced = sum(d["coalesced"] for d in same)
            if (coalesced != 2 or delta[home_tag] != 1 or sum(delta.values()) != 1
                    or {d["replica"] for d in same} != {reps[home_tag]["url"]}):
                raise AssertionError(f"route (b): coalesced {coalesced}, runs {delta}")
            out["b"] = {"wall_s": time.monotonic() - t0, "coalesced": coalesced, "runs": delta}
            log(f"route (b): 3 identical requests, one run on {home_tag}, 2 coalesced")

            # (c) mid-stream failover, alone on an idle fleet. The reference
            # run and the near-tie check (teacher forcing on the card) go
            # through ``gw_reference``: their launches are counted apart.
            ports = [rep["port"] for rep in reps.values()]
            body_c = homed("Fail over this stream", url_a)
            with gw_reference(ports, counters, reference, "route"):
                ref_c = route_sse(reps["b"]["port"], body_c, "c0ffee00ref0000c")
            runs_a = route_runs(reps["a"])
            trace_c = "c0ffee000000000c"
            got_c = route_sse(rport, body_c, trace_c)
            route_wait_runs(reps["a"], runs_a + 1, "(c)")
            done = got_c["done"]
            if done.get("failovers") != 1 or done.get("replica") != url_b:
                raise AssertionError(f"route (c): done {done}")
            with gw_reference(ports, counters, reference, "route"):
                tie_c = route_texts_match(
                    torch, "(c)", got_c["text"], ref_c["text"], slog,
                    [("a", trace_c), ("b", trace_c), ("b", "c0ffee00ref0000c")], reps)
            router.monitor.poll_once()  # the router's own evidence made a suspect
            out["c"] = {"wall_s": got_c["wall_s"], "reference_s": ref_c["wall_s"],
                        "chunks": sum(1 for _t, n, _d in got_c["events"] if n == "chunk"),
                        "text": tie_c, "chars": {k: len(v) for k, v in got_c["text"].items()}}
            log(f"route (c): replica a lost at frame {ROUTE_DOWN_FRAME}, the stream finished on b "
                f"in {got_c['wall_s']:.2f} s, text equal to the reference {tie_c['equal']}")

            # (d) retire with live migration: one panel model, 48 tokens.
            body_d = homed("Migrate this stream", url_a,
                           {"models": [ROUTE_PANEL[0]], "max_tokens": ROUTE_MIGRATE_TOKENS})
            with gw_reference(ports, counters, reference, "route"):
                ref_d = route_sse(reps["b"]["port"], body_d, "d00d00d0ref0000d")
            trace_d = "d00d00d00000000d"
            box: dict = {}
            client = threading.Thread(target=lambda: box.update(got=route_sse(
                rport, body_d, trace_d)), daemon=True)
            client.start()
            # Retire once the source's journal holds decoded tokens of the
            # stream (text may lag the tokens: random weights' ids decode to
            # little text).
            deadline = time.monotonic() + 120
            while not any(e.trace == trace_d and e.tokens()
                          for e in reps["a"]["provider"].journal.active()):
                if time.monotonic() > deadline or not client.is_alive():
                    raise AssertionError("route (d): the stream never decoded on a")
                time.sleep(0.005)
            flash0 = fa.LAUNCHES.count
            t_retire = time.monotonic()
            status, _h, data, retire_s, _sse = gw_post(reps["a"]["port"], {"to": url_b},
                                                      path="/v1/retire")
            retire = json.loads(data)
            client.join(300)
            if "got" not in box:
                raise AssertionError("route (d): the client never finished")
            got_d = box["got"]
            if status != 200 or retire != {"residents": 1, "migrated": 1, "fallback": 0,
                                           "lifecycle": "retiring"}:
                raise AssertionError(f"route (d): retire {status} {retire}")
            payload = (shipped[-1]["resume"] if shipped else {}).get(ROUTE_PANEL[0], {})
            tokens = payload.get("tokens") or []
            if not tokens or "text" in payload:
                raise AssertionError(f"route (d): the record carries {sorted(payload)}")
            b_engine = reps["b"]["engines"][ROUTE_PANEL[0].split(":", 1)[1]]
            resumed = [it for it in slog.traced(b_engine, trace_d) if it.replay_ids == tokens]
            flash_resume = fa.LAUNCHES.count - flash0
            if len(resumed) != 1 or flash_resume < b_engine.cfg.n_layers:
                raise AssertionError(f"route (d): resumed {len(resumed)} on b, flash "
                                     f"{flash_resume}")
            done = got_d["done"]
            if done.get("failovers") != 1 or done.get("replica") != url_b:
                raise AssertionError(f"route (d): done {done}")
            tie_d = {"equal": True}
            if got_d["text"] != ref_d["text"]:
                (res,), (ref_it,) = resumed, slog.traced(b_engine, "d00d00d0ref0000d")
                with gw_reference(ports, counters, reference, "route"):
                    tie_d = greedy_check(torch, b_engine, "route (d) resumed stream",
                                         res.prompt_ids, res.future.result(timeout=60).token_ids,
                                         ref_it.future.result(timeout=60).token_ids)
            # Wall from the retire to the first chunk the client got after it.
            after = [got_d["t0"] + t for t, n, _d in got_d["events"]
                     if n == "chunk" and got_d["t0"] + t > t_retire]
            resume_s = after[0] - t_retire if after else None
            router.monitor.poll_once()  # a now advertises retiring
            out["d"] = {"retire": retire, "retire_post_s": retire_s,
                        "record_tokens": len(tokens), "flash_on_resume": flash_resume,
                        "retire_to_first_resumed_chunk_s": resume_s,
                        "wall_s": got_d["wall_s"], "reference_s": ref_d["wall_s"], "text": tie_d}
            log(f"route (d): retire {retire}; record {len(tokens)} tokens; {flash_resume} flash "
                f"launches for the resume on b; first resumed chunk {resume_s} s after the retire")

            # (e) the fleet's view.
            families = ("ttft", "e2e", "queue_wait", "token_latency", "judge_synthesis")

            def request_families(parsed):
                return {k: v for k, v in parsed["histograms"].items() if k[0] in families}

            merged = prom.merge([prom.parse_text(gw_get(rep["port"], "/metricsz")[1])
                                 for rep in reps.values()])
            fleet_view = prom.parse_text(gw_get(rport, "/metricsz")[1])
            if (request_families(fleet_view) != request_families(merged)
                    or not request_families(merged)):
                raise AssertionError("route (e): the router's /metricsz is not the merge")
            rstats = json.loads(gw_get(rport, "/statsz")[1])
            el = {tag: json.loads(gw_get(rep["port"], "/statsz")[1])["elastic"]
                  for tag, rep in reps.items()}
            wal_traces = [(read_wal(os.path.join(reps["b"]["wal"], f)) or {}).get(
                "header", {}).get("trace") for f in sorted(os.listdir(reps["b"]["wal"]))]
            traced = {"route": len(route_spans(rec_r, "route", trace_c)),
                      "engine_stream_a": len(route_spans(reps["a"]["rec"], "engine_stream",
                                                         trace_c)),
                      "engine_stream_b": len(route_spans(reps["b"]["rec"], "engine_stream",
                                                         trace_c)),
                      "journal_b_d": wal_traces.count(trace_d)}
            if (rstats["counters"]["failovers"] < 2 or el["a"]["migrations_out"] != 1
                    or el["b"]["migrations_in"] != 1 or el["b"]["migrations_resumed"] != 1
                    or min(traced.values()) < 1):
                raise AssertionError(f"route (e): counters {rstats['counters']}, elastic {el}, "
                                     f"trace {traced}")
            out["e"] = {"counters": rstats["counters"], "traced": traced,
                        "histograms": sum(h["count"] for h in request_families(merged).values()),
                        "elastic": {tag: {k: e[k] for k in ("lifecycle", "migrations_out",
                                                             "migrations_in",
                                                             "migrations_resumed")}
                                    for tag, e in el.items()}}
            log(f"route (e): /metricsz is the merge; counters {rstats['counters']}; trace {traced}")

            # (f) spillover once no replica is placeable.
            reps["b"]["gw"].set_lifecycle(elastic_mod.DRAINING)
            router.monitor.poll_once()
            if router.candidates("any"):
                raise AssertionError(f"route (f): still placeable {router.candidates('any')}")
            status, _h, data, spill_s, _sse = gw_post(
                rport, {"prompt": "Spill this one. " + PROMPT, "timeout": 60})
            spill = json.loads(data)
            tight, _h, _data, _w, _sse = gw_post(
                rport, {"prompt": "Too tight to spill. " + PROMPT, "timeout": 5})
            if (status != 200 or spill.get("degraded") != "remote" or tight != 503
                    or [r["model"] for r in spill["responses"]] != [REMOTE_MODEL]
                    or len(mock_bodies) != 1):
                raise AssertionError(f"route (f): {status} {spill}, tight {tight}")
            reps["b"]["gw"].set_lifecycle(elastic_mod.SERVING)
            out["f"] = {"spill_s": spill_s, "tight_status": tight}
            log(f"route (f): spilled to the local mock in {spill_s:.2f} s (degraded remote), "
                f"a 5 s deadline got {tight}")

            # (g) the route subcommand over replica b.
            stop, err, rc = threading.Event(), io.StringIO(), []
            sub = threading.Thread(target=lambda: rc.append(cli_main(
                ["route", "--replica", url_b, "--port", "0"], stdout=io.StringIO(), stderr=err,
                install_signal_handlers=False, shutdown=stop)), daemon=True)
            sub.start()
            try:
                gport = None
                deadline = time.monotonic() + 60
                while gport is None and time.monotonic() < deadline and sub.is_alive():
                    text = err.getvalue()
                    if "http://" in text:
                        gport = int(text.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)[1])
                    time.sleep(0.01)
                if gport is None:
                    raise AssertionError(f"route (g): never listened: {err.getvalue()}")
                answer = gw_post(gport, {"prompt": "Through the route subcommand. " + PROMPT})
                gdoc = gw_doc(answer, "route (g)")
            finally:
                stop.set()
                sub.join(60)
            if rc != [0] or gdoc["replica"] != url_b:
                raise AssertionError(f"route (g): rc {rc}, replica {gdoc['replica']}")
            out["g"] = {"wall_s": answer[3], "rc": rc[0]}
            log(f"route (g): `route` answered in {answer[3]:.2f} s over b, exit 0")
        finally:
            elastic_mod.ship_record = real_ship
            faults.install(None)
            if router is not None:
                router.close()
            for rep in reps.values():
                rep["gw"].close(drain=False, timeout=30.0)
                rep["provider"].release()
            obs.reset_planes()
    launches = {name: c.count - reference[name] for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches["flash_attention"] <= 0 or launches["decode_attention"] <= 0:
        raise AssertionError(f"route: a kernel of the path never launched: {launches}")
    out.update({"launches": launches, "reference_launches": reference, "peak_gb": peak,
                "wall_s": time.monotonic() - t_phase})
    log(f"route: launches through the router {launches} (references {reference}, not counted), "
        f"peak {peak:.2f} GB, phase {out['wall_s']:.1f} s")
    print(json.dumps({"route": out, "card": card}, default=str), flush=True)
    reps.clear()
    shutil.rmtree(tmp, ignore_errors=True)
    release_memory(torch)
    return out


# -- phase 8j: disaggregated prefill -> decode ------------------------------------

DISAGG_ARGS = ["--models", "gpu:llama-3-8b,gpu:consensus-1b", "--judge", "gpu:llama-3-8b",
               "--max-batch", "8", "--max-tokens", "16", "--cache-size", "0", "--port", "0",
               "--disagg"]
# The governor off (a busy pool reads as pressure 1.0 and would shed the
# phase's own requests, ROADMAP queue 3); a 2,048 MB arena a preset, so every
# handed-off prompt of the phase stays resident.
DISAGG_ENV = {"LLMC_PRESSURE": "0", "LLMC_KV_POOL_MB": "2048"}
DISAGG_RESIDENT_TOKENS = 128
DISAGG_WAVE_TOKENS = 32
HANDOFF_THREAD = "llmc-handoff-"


class ProviderCatch:
    """The ``gpu:`` provider each in-process ``serve`` builds (wraps
    ``cli.serve._gpu_provider``; restored on exit)."""

    def __enter__(self):
        from llm_consensus_tpu_torch.cli import serve as serve_cli

        self.mod, self.real, self.providers = serve_cli, serve_cli._gpu_provider, []

        def make(cfg, dev):
            provider = self.real(cfg, dev)
            self.providers.append(provider)
            return provider

        serve_cli._gpu_provider = make
        return self

    def __exit__(self, *exc):
        self.mod._gpu_provider = self.real


class RoleLaunches:
    """Flash launches made on a handoff worker's thread (the prefill role),
    counted beside the wrapper's own counter by wrapping its ``add``."""

    def __init__(self, counter):
        self.counter, self.prefill = counter, 0

    def __enter__(self):
        real, role = self.counter.add, self

        def add():
            if threading.current_thread().name.startswith(HANDOFF_THREAD):
                role.prefill += 1
            real()

        self.counter.add = add
        return self

    def __exit__(self, *exc):
        vars(self.counter).pop("add", None)


def serve_in_process(argv: list, data: str, stop: threading.Event, err: io.StringIO,
                     rc: list, label: str) -> tuple:
    """``main(["serve", ...])`` on a thread; returns (thread, port) once the
    banner names its address."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main

    server = threading.Thread(target=lambda: rc.append(cli_main(
        ["serve", *argv, "--data-dir", data], device=None, stdout=io.StringIO(), stderr=err,
        install_signal_handlers=False, shutdown=stop)), daemon=True)
    server.start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and server.is_alive():
        text = err.getvalue()
        if "http://" in text:
            return server, int(text.split("http://", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
        time.sleep(0.01)
    raise AssertionError(f"{label}: the server never listened: {err.getvalue()}")


def streams_by_prompt(items: list) -> dict:
    """(preset, prompt ids) → the stream's greedy tokens."""
    return {(it.engine.cfg.name, tuple(it.prompt_ids)): it.future.result(timeout=60).token_ids
            for it in items}


def disagg_texts(torch, label: str, on: list, off: list, items_on: list, items_off: list,
                 engines: dict) -> dict:
    """Disagg-on answers against disagg-off ones on the same engines: the
    consensus and each model's answer equal, or every differing stream
    within the near-tie rule under teacher forcing: against the other run's
    stream of the same prompt, or, for a judge prompt the other run never
    had (the panel answers land in completion order, which the judge prompt
    follows), against the engine's single-stream greedy tokens."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    def answers(doc):
        return doc["consensus"], {r["model"]: r["content"] for r in doc["responses"]}

    equal = [answers(a) == answers(b) for a, b in zip(on, off)]
    rows, unmatched = [], 0
    if not all(equal):
        ref = streams_by_prompt(items_off)
        for it in items_on:
            key = (it.engine.cfg.name, tuple(it.prompt_ids))
            toks = it.future.result(timeout=60).token_ids
            want = ref.get(key)
            if want is None:
                unmatched += 1
                want = it.engine.generate_ids(list(it.prompt_ids), SamplingParams(
                    max_new_tokens=it.sampling.max_new_tokens,
                    ignore_eos=it.sampling.ignore_eos)).token_ids
            if toks != want:
                rows.append(greedy_check(torch, engines[key[0]], f"{label} {key[0]} stream",
                                         list(key[1]), toks, want))
    log(f"{label}: answers equal to disagg off {equal}; streams at a near-tie {len(rows)}, "
        f"held to single-stream (no counterpart) {unmatched}")
    return {"equal": equal, "near_ties": rows, "single_stream_refs": unmatched}


def letters(seed: int, n: int) -> str:
    """``n`` lowercase letters and spaces from ``seed`` (one byte token each)."""
    import random

    rng = random.Random(seed)
    return "".join(rng.choice("abcdefghijklmnopqrstuvwxyz    ") for _ in range(n))


def disagg_gap(torch, fa, seed: int) -> dict:
    """(b) Four residents (1,501-token prompts, 128 tokens) decode; once each
    has 32 tokens a wave of four 1,501-token prompts (32 tokens) sharing a
    1,472-token preamble arrives, disagg off, then on, on one provider
    (llama-3-8b bf16, 8 rows, the KV pool at 2,048 MB; the pool emptied
    between the runs): the residents' longest gap between fetches from the
    wave's arrival to its first tokens (the serving phase's metric), the wave's time to
    first token, the handoff's stats; streams on against off. The residents
    admit classically in both runs, and the handoff is switched on only for
    the wave: the batcher consults the pool only when idle, so a resident
    handed off while another decodes is prefilled again in an interleaved
    wave, and when the worker split the residents over two waves the first
    could finish its 128 tokens before the last was live (the wait below
    then had nothing left to wait for)."""
    from llm_consensus_tpu_torch.providers.base import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.context import Context

    residents = ["Resident. " + letters(seed + 200 + i, 1480) for i in range(4)]
    preamble = "Shared preamble. " + letters(seed + 400, 1455)
    wave = [preamble + f" Question {i}: which one and why?" for i in range(4)]
    runs, items = [], {}
    with BatcherTrace(torch, fa) as tr, StreamLog() as slog:
        provider = GPUProvider(batch_streams=8, kv_pool=True, kv_pool_mb=2048.0, disagg=True,
                               ignore_eos=True)
        try:
            for on in (False, True):
                provider.disagg["disagg"] = False
                provider.kv_evict_cold(0.0)
                n0 = len(slog.items)
                res: list = [None] * 4
                wav: list = [None] * 4

                def one(box, i, prompt, n):
                    box[i] = provider.query_stream(Context.background(), Request(
                        model="gpu:llama-3-8b", prompt=prompt, max_tokens=n), None)

                ths = [threading.Thread(target=one, args=(res, i, p, DISAGG_RESIDENT_TOKENS),
                                        daemon=True) for i, p in enumerate(residents)]
                for th in ths:
                    th.start()
                deadline = time.monotonic() + 600
                while True:
                    b = provider._batchers.get("llama-3-8b")
                    live = [st for st in (list(b._slots) if b is not None else [])
                            if st is not None]
                    if len(live) == 4 and all(len(st.out_ids) >= 32 for st in live):
                        break
                    if time.monotonic() > deadline:
                        # Every thread's stack, and where the residents are,
                        # for the next reader of this failure.
                        faulthandler.dump_traceback(all_threads=True)
                        raise AssertionError(
                            f"disagg (b): the residents never decoded: live "
                            f"{[len(st.out_ids) for st in live]}, answered "
                            f"{[r is not None for r in res]}, handoff "
                            f"{provider.disagg_stats().get('llama-3-8b')}")
                    time.sleep(0.002)
                provider.disagg["disagg"] = on
                t_wave = tr.now()
                hs0 = provider.disagg_stats().get("llama-3-8b", {})
                wths = [threading.Thread(target=one, args=(wav, i, p, DISAGG_WAVE_TOKENS),
                                         daemon=True) for i, p in enumerate(wave)]
                for th in wths:
                    th.start()
                for th in ths + wths:
                    th.join(600)
                if any(r is None for r in res + wav):
                    raise AssertionError("disagg (b): a stream never answered")
                fetches = tr.spans("fetch")
                t_first = next(t1 for _, t1, a in fetches if t1 > t_wave and a["firsts"])
                ends = [t1 for _, t1, _ in fetches]
                gaps = [b2 - a for a, b2 in zip(ends, ends[1:]) if t_wave < b2 <= t_first]
                hs1 = provider.disagg_stats().get("llama-3-8b", {})
                row = {"disagg": on, "longest_gap_ms": 1e3 * max(gaps),
                       "ttft_ms": 1e3 * (t_first - t_wave), "fetches_during_wave": len(gaps),
                       "flash_during_wave": tr.flash_in(t_wave, t_first)}
                if on:
                    row["handoff"] = {k: hs1.get(k, 0) - hs0.get(k, 0)
                                      for k in ("completed", "fallbacks", "handoff_tokens",
                                                "prefill_tokens", "prefill_s", "handoff_s")}
                    if row["handoff"]["completed"] < 4 or row["handoff"]["fallbacks"]:
                        raise AssertionError(f"disagg (b): the wave's handoff {row['handoff']}")
                items[on] = list(slog.items[n0:])
                runs.append(row)
                log(f"disagg (b) {'on' if on else 'off'}: residents' longest gap between "
                    f"fetches while the wave filled {row['longest_gap_ms']:.1f} ms over "
                    f"{len(gaps)} fetches; wave time to first token {row['ttft_ms']:.1f} ms"
                    + (f"; handoff {row['handoff']}" if on else ""))
            engine = provider._engines["llama-3-8b"]
            got, ref = streams_by_prompt(items[True]), streams_by_prompt(items[False])
            checks = [greedy_check(torch, engine, f"disagg (b) stream {i}", list(key[1]),
                                   got[key], ref[key])
                      for i, key in enumerate(sorted(ref)) if key in got]
            if len(checks) != 8:
                raise AssertionError(f"disagg (b): {len(checks)} of 8 streams paired")
        finally:
            provider.release()
    ratio = runs[1]["longest_gap_ms"] / runs[0]["longest_gap_ms"]
    log(f"disagg (b): longest gap on against off {ratio:.2f}x")
    return {"runs": runs, "gap_ratio_on_off": ratio,
            "equal": [c["equal"] for c in checks]}


def run_disagg(torch, fa, da, card: str, seed: int, tmp: str) -> dict:
    """Phase 8j: ``serve --disagg`` in process over llama-3-8b and
    consensus-1b (bf16, full width, random weights from the seed, 8 batcher
    rows, the KV pool implied, 2,048 MB a preset, the governor off, the
    result cache off). Both roles share the card: the prefill worker runs
    its waves on a CUDA stream of its own and publishes into the decode
    engine's pool; the prefill engine shares the decode engine's weight
    tree, and takes only prompts of one prefill chunk. (a) 4 distinct
    ~350-token requests with disagg off, then on (the pool emptied
    between), the launches of both counted: the panel prompts take no
    handoff (consensus-1b submits none), llama-3-8b's judge prompts are
    handed off with no fallback and ``handoff_blocks`` > 0, the prefill
    role's flash launches (on the handoff threads) counted apart, the
    decode kernel launched, the answers equal to disagg off or within the
    near-tie rule; memory after
    the build and after the handoffs (no second weight tree); (c)
    ``prefill_worker_crash@wave=1`` on freshly built handoffs: the answer
    unchanged, the fallback counted; (d) consensus-1b swapped to seed + 1
    weights, then a ~700-token request (its lone-row wave establishes its
    prefix from the handed-off blocks): its stream against a fresh engine on
    the new weights; the /statsz ``disagg`` block and /metricsz; then (b)
    the residents' longest fetch gap while a 4 x 1,501-token wave is handed
    off, on against off (:func:`disagg_gap`). The served runs stay in
    ``<tmp>/data`` for the distill phase. Prints a ``{"disagg": ...}``
    line."""
    from llm_consensus_tpu_torch import faults
    from llm_consensus_tpu_torch.engine import Engine
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params, param_leaves

    t_phase = time.monotonic()
    fresh_planes()
    data = os.path.join(tmp, "data")
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    stop, err, rc = threading.Event(), io.StringIO(), []
    out: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with set_environ(DISAGG_ENV), ProviderCatch() as catch, StreamLog() as slog, \
            RoleLaunches(fa.LAUNCHES) as role:
        server, port = serve_in_process(DISAGG_ARGS, data, stop, err, rc, "disagg")
        try:
            provider = catch.providers[0]
            if not (provider.disagg["disagg"] and provider.kv["kv_pool"]):
                raise AssertionError(f"disagg: provider settings {provider.disagg} {provider.kv}")
            bodies = [{"prompt": f"Request {i} of four. " + PROMPT} for i in range(4)]

            # (a) disagg off, then on, on the same engines.
            provider.disagg["disagg"] = False
            for c in counters.values():
                c.reset()
            t0 = time.monotonic()
            n0 = len(slog.items)
            off = [gw_doc(a, f"disagg (a) off {i}") for i, a in enumerate(gw_fire(port, bodies))]
            off_s = time.monotonic() - t0
            items_off = list(slog.items[n0:])
            launches_off = {name: c.count for name, c in counters.items()}
            engines = {name: eng for name, eng in provider.engines().items()}
            weights = {name: sum(w.numel() * w.element_size()
                                 for _n, w in param_leaves(eng.params))
                       for name, eng in engines.items()}
            torch.cuda.synchronize()
            mem_built = torch.cuda.memory_allocated()
            provider.disagg["disagg"] = True
            provider.kv_evict_cold(0.0)
            for c in counters.values():
                c.reset()
            role.prefill = 0
            t0 = time.monotonic()
            n0 = len(slog.items)
            on = [gw_doc(a, f"disagg (a) on {i}") for i, a in enumerate(gw_fire(port, bodies))]
            on_s = time.monotonic() - t0
            items_on = list(slog.items[n0:])
            launches = {name: c.count for name, c in counters.items()}
            prefill_flash = role.prefill
            stats = provider.disagg_stats()
            kv = provider.kv_stats()
            torch.cuda.synchronize()
            mem_handoff = torch.cuda.memory_allocated()
            # One card: a handoff takes only a prompt of one prefill chunk
            # (the decode side reuses nothing shorter). The ~350-token panel
            # prompts take the classic path; llama-3-8b's four judge prompts
            # (~1,400 tokens) are handed off, prefilled in chunks.
            for name, snap in stats.items():
                if (snap["fallbacks"] or not snap["shared_device"]
                        or snap["min_tokens"] != provider.prefill_chunk):
                    raise AssertionError(f"disagg (a): {name} handoff {snap}")
            trees = {name: (h._pe.params is None) for name, (_e, h) in provider._handoffs.items()
                     if h is not None}
            if (set(stats) != {"llama-3-8b", "consensus-1b"} or not all(trees.values())
                    or stats["consensus-1b"]["submitted"] != 0
                    or stats["llama-3-8b"]["completed"] < 4
                    or kv["llama-3-8b"]["handoff_blocks"] <= 0
                    or launches["decode_attention"] <= 0):
                raise AssertionError(f"disagg (a): stats {stats}, kv {kv}, prefill-role flash "
                                     f"{prefill_flash}, launches {launches}, trees held {trees}")
            # One weight tree a preset: the handoffs add no tree beside the
            # decode engines' (a second consensus-1b tree alone is 1.77 GB).
            extra = (mem_handoff - mem_built) / 1e9
            if extra > 0.5 * min(weights.values()) / 1e9:
                raise AssertionError(f"disagg (a): {extra:.2f} GB more after the handoffs")
            texts = disagg_texts(torch, "disagg (a)", on, off, items_on, items_off, engines)
            out["a"] = {"off_s": off_s, "on_s": on_s, "launches": launches,
                        "launches_off": launches_off, "prefill_role_flash": prefill_flash,
                        "decode_role_flash": launches["flash_attention"] - prefill_flash,
                        "handoff": stats, "handoff_blocks": {n: kv[n]["handoff_blocks"]
                                                             for n in stats},
                        "memory_gb": {"weights": {n: w / 1e9 for n, w in weights.items()},
                                      "after_build": mem_built / 1e9,
                                      "after_handoffs": mem_handoff / 1e9},
                        "texts": texts}
            log(f"disagg (a): 4 requests off {off_s:.2f} s, on {on_s:.2f} s; handoffs "
                f"{ {n: (s['completed'], s['fallbacks'], s['waves']) for n, s in stats.items()} } "
                f"(completed, fallbacks, waves); handoff blocks {out['a']['handoff_blocks']}; "
                f"flash {launches['flash_attention']} ({prefill_flash} on the prefill role; "
                f"{launches_off['flash_attention']} off), decode "
                f"{launches['decode_attention']} ({launches_off['decode_attention']} off), state "
                f"{launches['decode_attention_state']} "
                f"({launches_off['decode_attention_state']} off); memory {mem_built / 1e9:.2f} GB built, "
                f"{mem_handoff / 1e9:.2f} GB with the handoffs")

            # (c) a crashed prefill wave falls back to the classic path.
            faults.install(faults.FaultPlan("prefill_worker_crash@wave=1", seed=seed))
            try:
                for _eng, h in list(provider._handoffs.values()):
                    if h is not None:
                        h.close()
                provider._handoffs.clear()  # rebuilt at the next request, binding the plan
                provider.kv_evict_cold(0.0)
                n0 = len(slog.items)
                crashed = gw_doc(gw_post(port, bodies[0]), "disagg (c)")
                items_c = list(slog.items[n0:])
                plan = faults.plan()
            finally:
                faults.install(None)
            fired = [t for t in plan.trace if t.endswith("->prefill_worker_crash")]
            cstats = provider.disagg_stats()
            if not fired or sum(s["fallbacks"] for s in cstats.values()) < 1:
                raise AssertionError(f"disagg (c): fired {fired}, stats {cstats}")
            tie_c = disagg_texts(torch, "disagg (c)", [crashed], [off[0]], items_c, items_off,
                                 engines)
            out["c"] = {"fired": len(fired), "fallbacks": {n: s["fallbacks"]
                                                           for n, s in cstats.items()},
                        "texts": tie_c}

            # (d) a swap, then a request past one prefill chunk.
            cfg = get_config("consensus-1b")
            ckpt = os.path.join(tmp, "consensus-1b-seed1")
            os.makedirs(ckpt)
            new = init_params(cfg, seed + 1, device=torch.device("cuda"))
            write_safetensors(os.path.join(ckpt, "model.safetensors"),
                              hf_tensors_from_params(cfg, new))
            del new
            release_memory(torch)
            status, _h, data_, _w, _s = gw_post(
                port, {"model": "gpu:consensus-1b", "checkpoint": ckpt, "wait": True},
                path="/v1/swap")
            swap = json.loads(data_)
            if status != 200 or swap.get("weight_version") != 1:
                raise AssertionError(f"disagg (d): swap {status} {swap}")
            before = provider.disagg_stats()["consensus-1b"]["completed"]
            gw_doc(gw_post(port, {"prompt": "Swap check. " + PROMPT + " " + PROMPT}),
                   "disagg (d)")
            if provider.disagg_stats()["consensus-1b"]["completed"] <= before:
                raise AssertionError("disagg (d): no handoff after the swap")
            fresh = Engine(cfg, try_load_params(cfg, ckpt, device=torch.device("cuda")))
            row_d = gw_stream_check(torch, slog, fresh, "consensus-1b", "Swap check.",
                                    "disagg (d) stream after the swap against a fresh engine")
            del fresh
            release_memory(torch)
            statsz = json.loads(gw_get(port, "/statsz")[1])
            metrics = gw_get(port, "/metricsz")[1]
            if ("disagg" not in statsz or "llama-3-8b:prefill" not in statsz["utilization"]
                    or 'block="disagg"' not in metrics):
                raise AssertionError(f"disagg: /statsz blocks {sorted(statsz)}")
            out["d"] = {"swap": {k: swap.get(k) for k in ("weight_version", "last_prep_ms",
                                                          "last_vacate_ms")}, "stream": row_d}
            out["statsz_disagg"] = statsz["disagg"]
            stop.set()
            server.join(300)
            if rc != [0]:
                raise AssertionError(f"disagg: serve returned {rc}: {err.getvalue()[-800:]}")
        finally:
            stop.set()
            server.join(300)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    release_memory(torch)
    out["b"] = disagg_gap(torch, fa, seed)
    out["wall_s"] = time.monotonic() - t_phase
    log(f"disagg: peak {out['peak_gb']:.2f} GB, phase {out['wall_s']:.1f} s")
    print(json.dumps({"disagg": out, "card": card}, default=str), flush=True)
    release_memory(torch)
    return out


# -- phase 8k: distillation and the swap of its checkpoint ------------------------------

DISTILL_STUDENT = "consensus-1b"
DISTILL_STEPS = "8"
# Half the examples held out: the phase's corpus is a handful of runs (the
# disagg phase's off and on runs dedupe), and the default 0.2 can leave the
# holdout empty (the loss is then read on the training examples).
DISTILL_HOLDOUT = "0.5"


class StampedIO(io.StringIO):
    """A text sink that keeps each line's host time (the distill CLI's
    progress lines, one a step)."""

    def __init__(self):
        super().__init__()
        self.stamps: list = []

    def write(self, text):
        if text.strip():
            self.stamps.append((time.monotonic(), text.strip()))
        return super().write(text)


def make_runs(data: str) -> int:
    """Three auto-saved one-shot runs (consensus-1b twice on the panel and as
    judge, 16 tokens) when ``data`` holds no run: the distill phase alone."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main

    for i in range(3):
        rc = cli_main(["--models", "gpu:consensus-1b,gpu:consensus-1b", "--judge",
                       "gpu:consensus-1b", "--max-tokens", "16", "--data-dir", data,
                       f"Distill corpus question {i}. " + PROMPT],
                      device=None, stdout=io.StringIO(), stderr=io.StringIO(),
                      install_signal_handlers=False)
        if rc != 0:
            raise AssertionError(f"distill: corpus run {i} exited {rc}")
    fresh_planes()
    return 3


def run_distill(torch, card: str, seed: int, tmp: str) -> dict:
    """Phase 8k: ``distill --student consensus-1b --steps 8`` in process at
    full width (d 2048, 16 layers, vocab 32,000; float32, the student and the
    teacher random from seeds 0 and 1, as in JAX; teacher = student preset)
    over the runs the disagg phase auto-saved in ``<tmp>/data`` (three
    one-shot runs made first when there are none): the holdout loss before
    and after, each step's wall, peak memory. Then ``serve`` over
    consensus-1b with the integrity plane on takes the checkpoint through
    ``POST /v1/swap {"out_dir"}`` (its digest checked on the tree as
    stored), and a request's stream equals a fresh engine loaded from the
    checkpoint, up to the near-tie rule. Prints a ``{"distill": ...}``
    line."""
    from llm_consensus_tpu_torch import integrity
    from llm_consensus_tpu_torch.cli.main import main as cli_main
    from llm_consensus_tpu_torch.engine import Engine
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.flywheel.distill import latest_checkpoint
    from llm_consensus_tpu_torch.models import get_config

    t_phase = time.monotonic()
    fresh_planes()
    data = os.path.join(tmp, "data")
    os.makedirs(data, exist_ok=True)
    made = 0 if any(os.path.exists(os.path.join(data, d, "run.json"))
                    for d in os.listdir(data)) else make_runs(data)
    outdir = os.path.join(tmp, "distill")
    stdout, stderr = io.StringIO(), StampedIO()
    release_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    rc = cli_main(["distill", "--data-dir", data, "--student", DISTILL_STUDENT, "--steps",
                   DISTILL_STEPS, "--holdout", DISTILL_HOLDOUT, "--out", outdir], device=None,
                  stdout=stdout, stderr=stderr, install_signal_handlers=False)
    distill_s = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"distill: exit {rc}: {stdout.getvalue()[-800:]} "
                             f"{stderr.getvalue()[-800:]}")
    summary = json.loads(stdout.getvalue())
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = [t for t, line in stderr.stamps if line.startswith("distill step")]
    step_s = [b - a for a, b in zip(steps, steps[1:])]
    losses = (summary["holdout_loss_before"], summary["holdout_loss_after"])
    if (summary["steps"] != int(DISTILL_STEPS) or summary.get("weight_version") != 1
            or not all(x == x and abs(x) < 1e6 for x in losses)):
        raise AssertionError(f"distill: summary {summary}")
    latest = latest_checkpoint(outdir)
    if not summary["corpus"]["holdout"]:
        log("distill: the holdout split is empty; its loss is read on the training examples")
    log(f"distill: {summary['corpus']['train']} train / {summary['corpus']['holdout']} "
        f"holdout examples ({made} runs made here); holdout loss {losses[0]:.4f} -> "
        f"{losses[1]:.4f}; steps {[round(x, 3) for x in step_s]} s apart; run {distill_s:.1f} s;"
        f" peak {peak:.2f} GB")
    release_memory(torch)

    # The checkpoint through /v1/swap's out_dir form, the digest checked.
    stop, err, srv_rc = threading.Event(), io.StringIO(), []
    with set_environ({"LLMC_PRESSURE": "0", "LLMC_INTEGRITY": "1"}), StreamLog() as slog:
        server, port = serve_in_process(
            ["--models", "gpu:consensus-1b", "--judge", "gpu:consensus-1b", "--max-batch", "2",
             "--max-tokens", "16", "--cache-size", "0", "--port", "0"],
            os.path.join(tmp, "distill-serve"), stop, err, srv_rc, "distill")
        try:
            t0 = time.monotonic()
            status, _h, data_, _w, _s = gw_post(
                port, {"model": "gpu:consensus-1b", "out_dir": outdir, "wait": True},
                path="/v1/swap")
            swap_s = time.monotonic() - t0
            swap = json.loads(data_)
            if status != 200 or swap.get("weight_version") != 1:
                raise AssertionError(f"distill: swap {status} {swap}")
            status, _h, body, _w, _s = gw_post(port, {"prompt": "Distilled check. " + PROMPT})
            doc = json.loads(body)
            if status != 200 or not doc.get("consensus"):
                raise AssertionError(f"distill: request {status} {body[:400]!r}")
            cfg = get_config(DISTILL_STUDENT)
            fresh = Engine(cfg, try_load_params(cfg, latest["params_path"],
                                                device=torch.device("cuda")))
            row = gw_stream_check(torch, slog, fresh, DISTILL_STUDENT, "Distilled check.",
                                  "distill stream on the swapped checkpoint against a fresh "
                                  "engine")
            del fresh
            stats = json.loads(gw_get(port, "/statsz")[1])
            ckpt_checks = stats.get("integrity", {}).get("checks", {}).get("ckpt", 0)
            if ckpt_checks < 1:
                raise AssertionError(f"distill: no checkpoint digest check: "
                                     f"{stats.get('integrity')}")
            stop.set()
            server.join(300)
            if srv_rc != [0]:
                raise AssertionError(f"distill: serve returned {srv_rc}: {err.getvalue()[-800:]}")
        finally:
            stop.set()
            server.join(300)
            integrity.reset()  # the serve installed the plane: no later phase keeps it
    out = {"summary": {k: summary.get(k) for k in (
               "steps", "batch", "seq", "loss", "kl", "ce", "grad_norm", "holdout_loss_before",
               "holdout_loss_after", "weight_version")},
           "corpus": summary["corpus"], "runs_made": made, "distill_s": distill_s,
           "step_s": step_s, "peak_gb": peak, "swap_s": swap_s,
           "swap": {k: swap.get(k) for k in ("weight_version", "last_prep_ms", "last_vacate_ms")},
           "stream": row, "ckpt_checks": ckpt_checks, "wall_s": time.monotonic() - t_phase}
    log(f"distill: swapped in through out_dir in {swap_s:.2f} s; stream equal to a fresh "
        f"engine {row['equal']}; phase {out['wall_s']:.1f} s")
    print(json.dumps({"distill": out, "card": card}, default=str), flush=True)
    release_memory(torch)
    return out


# -- phase 8l: parallel/ over a mesh of positions on the one card ----------------------

HEAD_SLICES = (
    # (record, tp, Hq, Hkv): llama-3-8b's heads over tp positions
    ("tp2", 2, 16, 4),
    ("tp8", 8, 4, 1),
)


def head_record(recs: dict, name: str, source: str, replaces: str, shapes: str, err: float,
                kern: dict, plain_ms: float, lib, nbytes: float, flops: float) -> None:
    """One head-slice row of the kernels line: its times, bound and library
    call; ``launches`` is filled in by the parallel phase's main-path run."""
    bms, by = bound_ms(nbytes, flops)
    recs[name] = dict(
        name=name, route="cuda", source=source, replaces=replaces, shapes=shapes,
        launches=0, max_abs_err=err, ms=kern["ms"], cold_ms=kern["cold_ms"],
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        bound_share=bms / kern["cold_ms"],
        library_ms=None if lib is None else lib["ms"],
        library_cold_ms=None if lib is None else lib["cold_ms"])
    log(f"head slice {name}: {shapes}: max_abs_err {err:.3e}; kernel warm "
        f"{kern['ms']:.4f} ms, cold {kern['cold_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
        + ("" if lib is None else f"library warm {lib['ms']:.4f}, cold {lib['cold_ms']:.4f} ms; ")
        + f"bound {bms:.5f} ms ({by}), {100 * bms / kern['cold_ms']:.1f} % of it cold")


TP2_ROWS = (0, 40, 80, 120)  # the B = 4 decode row's ragged starts (parallel (f)'s wave)
TP2_STATE_ROWS = (0, 37, 255, 5)  # the state row's, as the full-head B = 4 row's


def check_head_slices_b4(torch, recs: dict) -> None:
    """The shapes each tp 2 shard of llama-3-8b gives the kernels under the
    batcher (parallel (f)): flash at the B = 4 wave, q[4,512,16,128]; the
    bf16 decode at q[4,1,16,128] over [32,4,8192,4,128] with ragged row
    starts at width 512; its ``return_state`` form at width 256. Each
    against its plain version, timed warm and cold against the plain
    version and the library call (SDPA; for the state form aten's
    memory-efficient attention with its log-sum-exp), K/V expanded to 16
    heads with the row starts as a bias mask."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, t, hq, hkv, dh = 4, 512, 16, 4, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v = rnd(b, t, hq, dh), rnd(b, t, hkv, dh), rnd(b, t, hkv, dh)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = max_err(got, fa.flash_attention_plain(q, k, v))
    if not bool(torch.isfinite(got).all()) or err > FLASH_TOL:
        raise AssertionError(f"flash_attention tp 2 B = 4: err {err}")
    kern = timed(lambda: fa.flash_attention(q, k, v), 50)
    plain_ms, _ = device_time_ms(lambda: fa.flash_attention_plain(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
    lib = timed(lambda: sdpa(qt, kt, vt, is_causal=True), 50)
    head_record(recs, "flash_attention_tp2_b4", "llm_consensus_tpu_torch/csrc/flash_attention.cu",
                "llm_consensus_tpu/ops/pallas/flash_attention.py:136",
                f"q[{b},{t},{hq},{dh}] k/v[{b},{t},{hkv},{dh}] bf16 (llama-3-8b at tp 2, the "
                "batcher's B = 4 wave)", err, kern, plain_ms, lib,
                2.0 * b * (2 * t * hq * dh + 2 * t * hkv * dh), 4.0 * b * hq * dh * (t * (t + 1) // 2))
    del q, k, v, qt, kt, vt
    decode_b4_rows(torch, recs, gen, hq, hkv, (
        ("decode_attention_tp2_b4", False, 511, 512, TP2_ROWS),
        ("decode_attention_state_tp2_b4", True, 255, 256, TP2_STATE_ROWS)))
    release_memory(torch)


def decode_b4_rows(torch, recs: dict, gen, hq: int, hkv: int, rows: tuple) -> None:
    """B = 4 rows of the bf16 decode kernel over a [32,4,8192,hkv,128]
    cache at layer 5: each ``(name, state, pos, width, row starts)`` against
    its plain version, timed warm and cold against the plain version and
    the library call (SDPA; for the state form aten's memory-efficient
    attention with its log-sum-exp), K/V expanded to ``hq`` heads with the
    row starts as a bias mask."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da

    sdpa = torch.nn.functional.scaled_dot_product_attention
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    b, dh, L, S, layer = 4, 128, 32, 8192, 5

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    k, v, q = rnd(L, b, S, hkv, dh), rnd(L, b, S, hkv, dh), rnd(b, 1, hq, dh)
    layer_t = torch.full((), layer, dtype=torch.int32, device="cuda")
    qt = q.transpose(1, 2)
    for name, state, pos, w, starts in rows:
        rs_t = torch.tensor(starts, dtype=torch.int32, device="cuda")
        pos_t = torch.full((), pos, dtype=torch.int32, device="cuda")
        kw = dict(kv_width=w, return_state=state)

        def call(kw=kw, pos_t=pos_t, rs_t=rs_t):
            return da.decode_attention(q, k, v, pos_t, layer_t, rs_t, **kw)

        got = call()
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k, v, pos, layer, rs_t, **kw)
        got0, want0 = (got[0], want[0]) if state else (got, want)
        err = max_err(got0, want0)
        m_err = l_err = 0.0
        if state:
            m_err = max_err(got[1], want[1])
            l_err = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
        finite = all(bool(torch.isfinite(x).all()) for x in (got if state else (got,)))
        if (not finite or err > decode_tol(want0) or m_err > STATE_M_TOL
                or l_err > STATE_L_REL_TOL):
            raise AssertionError(f"{name}: out {err}, m {m_err}, "
                                 f"l {l_err}, finite {finite}")
        kern = timed(call, 200)
        plain_ms, _ = device_time_ms(
            lambda kw=kw, pos_t=pos_t, rs_t=rs_t: da.decode_attention_plain(
                q, k, v, pos_t, layer_t, rs_t, **kw), 10)
        kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        cols = torch.arange(w, device="cuda")
        valid = (cols[None, :] <= pos) & (cols[None, :] >= rs_t[:, None].long())
        bias = torch.zeros((b, hq, 1, w), dtype=torch.bfloat16, device="cuda")
        bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
        if state:
            lib = timed(lambda: efficient(qt, kt, vt, bias, True), 200)
        else:
            lib = timed(lambda: sdpa(qt, kt, vt, attn_mask=bias), 200)
        n_valid = sum(pos - r + 1 for r in starts)
        io_bytes = 2.0 * 2 * b * hq * dh + (2 * 4 * b * hq if state else 0)
        head_record(recs, name, "llm_consensus_tpu_torch/csrc/decode_attention.cu",
                    "llm_consensus_tpu/ops/pallas/decode_attention.py:415"
                    + (" (return_state :139-147)" if state else ""),
                    f"q[{b},1,{hq},{dh}] cache[{L},{b},{S},{hkv},{dh}] bf16, pos {pos}, width {w}, "
                    f"row starts {list(starts)}" + (", return_state" if state else ""),
                    err, kern, plain_ms, lib, 2.0 * 2 * n_valid * hkv * dh + io_bytes,
                    4.0 * hq * dh * n_valid)
        if state:
            recs[name].update(m_max_abs_err=m_err, l_max_rel_err=l_err)
        del kt, vt, bias
    del k, v, q
    release_memory(torch)


# generate_batch's step of the batched phase: four ragged prompts (tokens, BOS
# included) left-padded to the 512-token bucket, 32 tokens each; its decode
# kernel row at the first step (pos 512, width 640).
GB_LENGTHS = (37, 120, 255, 350)
GB_TOKENS = 32
GB_ROWS = tuple(512 - n for n in GB_LENGTHS)


def check_decode_batch(torch, recs: dict) -> None:
    """The shape ``Engine.generate_batch`` gives the bf16 decode kernel on
    llama-3-8b in the batched phase: q[4,1,32,128] over [32,4,8192,8,128] at
    its first step (pos 512, width 640) with the ragged prompts' row starts,
    against its plain version, timed as :func:`decode_b4_rows` does."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    decode_b4_rows(torch, recs, gen, 32, 8,
                   (("decode_attention_batch_b4", False, 512, 640, GB_ROWS),))
    release_memory(torch)


def batched_generate_batch(torch, fa, da, engine, seed: int) -> dict:
    """``Engine.generate_batch`` on the batched phase's llama-3-8b engine:
    four ragged random prompts (37, 120, 255 and 350 tokens), 32 tokens
    each. Every row's tokens equal that prompt's single-stream generate or
    are near-ties; the batch prefill launches no flash kernel (the plain op,
    as the JAX engine sends it to XLA); the decode kernel launches exactly
    once a layer a step."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    prompts = [kv_text(torch, seed + 40 + i, n - 1) for i, n in enumerate(GB_LENGTHS)]
    ids = [engine.tokenizer.encode(p) for p in prompts]
    if [len(x) for x in ids] != list(GB_LENGTHS):
        raise AssertionError(f"generate_batch: prompt lengths {[len(x) for x in ids]}")
    sp = SamplingParams(max_new_tokens=GB_TOKENS, ignore_eos=True)
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    got = engine.generate_batch(prompts, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: c.count for name, c in counters.items()}
    chunk = engine.stream_interval
    steps = -(-(GB_TOKENS - 1) // chunk) * chunk  # the dispatched decode steps
    rows = [greedy_check(torch, engine, f"generate_batch row {i} ({n} tokens)", ids[i],
                         got[i].token_ids, engine.generate(prompts[i], sp).token_ids)
            for i, n in enumerate(GB_LENGTHS)]
    want = {"flash_attention": 0, "decode_attention": steps * engine.cfg.n_layers,
            "decode_attention_state": 0}
    log(f"generate_batch: 4 rows of {list(GB_LENGTHS)} tokens, {GB_TOKENS} tokens each in "
        f"{wall:.3f} s ({4 * GB_TOKENS / wall:.2f} tokens/s), launches {launches} (want {want}), "
        f"rows equal to single-stream {[r['equal'] for r in rows]}")
    if launches != want or any(len(r.token_ids) != GB_TOKENS for r in got):
        raise AssertionError(f"generate_batch: launches {launches} (want {want}), "
                             f"lengths {[len(r.token_ids) for r in got]}")
    return {"wall_s": wall, "launches": launches, "rows": rows}


def check_head_slices(torch, recs: dict) -> None:
    """Both kernels on the head slices a tensor-parallel shard of
    llama-3-8b gives them (tp 2: Hq 16 / Hkv 4; tp 8: Hq 4 / Hkv 1; the
    group stays 4), against their plain versions, timed warm and cold
    against the plain version and SDPA: flash at q[1,512,Hq,128], bf16
    decode over [32,1,8192,Hkv,128] at width 384, and the int8 decode at
    tp 2. Each shard's cache is a contiguous tensor of its heads, as the
    sharded engine allocates it."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device="cuda")

    def record(*args):
        head_record(recs, *args)

    t, dh, L, S, layer, pos, w = 512, 128, 32, 8192, 7, 383, 384
    for tag, _tp, hq, hkv in HEAD_SLICES:
        # Flash, one-shot prefill of the slice's bucket.
        q, k, v = rnd(1, t, hq, dh), rnd(1, t, hkv, dh), rnd(1, t, hkv, dh)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got, fa.flash_attention_plain(q, k, v))
        if not bool(torch.isfinite(got).all()) or err > FLASH_TOL:
            raise AssertionError(f"flash_attention {tag} head slice: err {err}")
        kern = timed(lambda: fa.flash_attention(q, k, v), 50)
        plain_ms, _ = device_time_ms(lambda: fa.flash_attention_plain(q, k, v), 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kt, vt = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
        lib = timed(lambda: sdpa(qt, kt, vt, is_causal=True), 50)
        record(f"flash_attention_{tag}", "llm_consensus_tpu_torch/csrc/flash_attention.cu",
               "llm_consensus_tpu/ops/pallas/flash_attention.py:136",
               f"q[1,{t},{hq},{dh}] k/v[1,{t},{hkv},{dh}] bf16 (llama-3-8b at {tag})", err,
               kern, plain_ms, lib, 2.0 * (2 * t * hq * dh + 2 * t * hkv * dh),
               4.0 * hq * dh * (t * (t + 1) // 2))
        del q, k, v, qt, kt, vt
        # bf16 decode over the shard's contiguous cache.
        k, v, q = rnd(L, 1, S, hkv, dh), rnd(L, 1, S, hkv, dh), rnd(1, 1, hq, dh)
        rs0 = torch.zeros(1, dtype=torch.int32, device="cuda")
        pos_t, layer_t = i32(pos), i32(layer)
        got = da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w)
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k, v, pos, layer, rs0, kv_width=w)
        err = max_err(got, want)
        if not bool(torch.isfinite(got).all()) or err > decode_tol(want):
            raise AssertionError(f"decode_attention {tag} head slice: err {err}")
        kern = timed(lambda: da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w), 200)
        plain_ms, _ = device_time_ms(
            lambda: da.decode_attention_plain(q, k, v, pos_t, layer_t, rs0, kv_width=w), 10)
        qt = q.transpose(1, 2)
        kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        lib = timed(lambda: sdpa(qt, kt, vt), 200)
        n = pos + 1
        record(f"decode_attention_{tag}", "llm_consensus_tpu_torch/csrc/decode_attention.cu",
               "llm_consensus_tpu/ops/pallas/decode_attention.py:415",
               f"q[1,1,{hq},{dh}] cache[{L},1,{S},{hkv},{dh}] bf16, pos {pos}, width {w}",
               err, kern, plain_ms, lib, 2.0 * (2 * n * hkv * dh + 2 * hq * dh),
               4.0 * hq * dh * n)
        del k, v, kt, vt
        torch.cuda.empty_cache()
        if tag != "tp2":
            continue
        # The int8 decode at tp 2: codes beside their scales, one shard's heads.
        sides = []
        for _ in range(2):
            q8 = torch.empty((L, 1, S, hkv, dh), dtype=torch.int8, device="cuda")
            sc = torch.empty((L, 1, hkv, S), dtype=torch.bfloat16, device="cuda")
            for i in range(L):
                codes, scale = quantize_kv(rnd(1, S, hkv, dh))
                q8[i].copy_(codes)
                sc[i].copy_(scale[..., 0].transpose(1, 2))
            sides.append({"q8": q8, "s": sc})
        k8, v8 = sides
        got = da.decode_attention(q, k8, v8, pos_t, layer_t, rs0, kv_width=w)
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k8, v8, pos, layer, rs0, kv_width=w)
        err = max_err(got, want)
        if not bool(torch.isfinite(got).all()) or err > decode_tol(want):
            raise AssertionError(f"decode_attention int8 {tag} head slice: err {err}")
        kern = timed(lambda: da.decode_attention(q, k8, v8, pos_t, layer_t, rs0, kv_width=w), 200)
        plain_ms, _ = device_time_ms(
            lambda: da.decode_attention_plain(q, k8, v8, pos_t, layer_t, rs0, kv_width=w), 10)
        record(f"decode_attention_int8_{tag}", "llm_consensus_tpu_torch/csrc/decode_attention.cu",
               "llm_consensus_tpu/ops/pallas/decode_attention.py:415 (body _qstruct_block :268)",
               f"q[1,1,{hq},{dh}] int8 cache[{L},1,{S},{hkv},{dh}] + bf16 scales, pos {pos}, "
               f"width {w}", err, kern, plain_ms, None,
               2.0 * n * hkv * (dh + 2) + 2.0 * 2 * hq * dh, 4.0 * hq * dh * n)
        del k8, v8, sides
        torch.cuda.empty_cache()


class ShardLaunches:
    """Each attention kernel call the sharded forward makes, by shard: wraps
    the transformer module's kernel entry points for the block and records
    every call's kind (the decode kernel's ``return_state`` form apart),
    head counts and rows; the sharded forward issues the shards of a layer
    in order, so call ``i`` of a kind belongs to shard ``i % tp`` (only one
    sharded engine may run kernels inside the block). The launch counts
    themselves are the wrappers' LaunchCounters."""

    def __init__(self, tp: int):
        self.tp = tp
        self.calls: list = []

    def __enter__(self):
        import llm_consensus_tpu_torch.models.transformer as tr

        self._tr = tr
        self._real = {n: getattr(tr, n) for n in ("flash_attention", "decode_attention")}
        for name, real in self._real.items():
            def wrapped(q, k, *a, _r=real, _n=name, **kw):
                kk = k["q8"] if isinstance(k, dict) else k
                kind = _n + "_state" if kw.get("return_state") else _n
                self.calls.append((kind, q.shape[2], kk.shape[-2], q.shape[0]))
                return _r(q, k, *a, **kw)
            setattr(tr, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self._tr, name, real)

    def by_shard(self) -> dict:
        out: dict = {}
        for kind in ("flash_attention", "decode_attention", "decode_attention_state"):
            calls = [c for c in self.calls if c[0] == kind]
            out[kind] = [sum(1 for i, _ in enumerate(calls) if i % self.tp == s)
                         for s in range(self.tp)]
            out[kind + "_heads"] = sorted({c[1:3] for c in calls})
        return out

    def at_batch(self, kind: str, b: int) -> int:
        """Calls of ``kind`` with ``b`` query rows."""
        return sum(1 for c in self.calls if c[0] == kind and c[3] == b)


def gb(torch) -> float:
    return torch.cuda.memory_allocated() / 1e9


PAR_WORKER = r'''
import io, json, os, sys
from llm_consensus_tpu_torch.cli.main import create_provider, parse_args, run
from llm_consensus_tpu_torch.parallel import multicontroller as mc
from llm_consensus_tpu_torch.utils.context import Context
from functools import partial

out_dir, argv = sys.argv[1], json.loads(sys.argv[2])
cfg = parse_args(argv, io.StringIO(""), io.StringIO())
ctx = Context.background()
err = io.StringIO()
result = run(cfg, ctx, factory=partial(create_provider, device=None), stdout=io.StringIO(),
             stderr=err)
rank = mc.process_index()
with open(os.path.join(out_dir, f"result-{rank}.json"), "w") as f:
    f.write(result.to_json())
print(json.dumps({"rank": rank, "count": mc.process_count(), "err": err.getvalue()[-400:]}))
'''

NCCL_WORKER = r'''
import json, os, sys
import torch
import torch.distributed as dist
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import init_params
from llm_consensus_tpu_torch.parallel import distributed, make_mesh, virtual_devices
from llm_consensus_tpu_torch.train.step import init_train_state, make_train_step, sgd

port = sys.argv[1]
cfg = get_config("consensus-1b")
dev = torch.device("cuda")
tree = init_params(cfg, 0, device=dev, dtype=torch.float32)
gen = torch.Generator().manual_seed(3)
tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen).to(dev)
batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1),
         "mask": torch.ones(2, 128, device=dev)}
mesh = make_mesh({"dp": 1}, virtual_devices(1, "cuda"))
out = {}
for grouped in (False, True):
    if grouped:
        assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=120)
        out["backend"] = str(dist.get_backend())
        seen = []
        real = dist.all_reduce
        dist.all_reduce = lambda t, *a, **k: seen.append(t.device.type) or real(t, *a, **k)
    state = init_train_state(cfg, 0, sgd(1e-2), params=tree, mesh=mesh, dtype=torch.float32)
    state, m = make_train_step(cfg, remat=True, mesh=mesh)(state, batch)
    grads = [w.grad.detach().clone() for w in state.leaves()]
    out["grouped" if grouped else "alone"] = {"loss": m["loss"], "grad_norm": m["grad_norm"]}
    if not grouped:
        ref = grads
        del state
    torch.cuda.synchronize()
out["all_reduces"] = len(seen)
out["all_reduce_devices"] = sorted(set(seen))
out["grads_equal"] = all(torch.equal(a, b) for a, b in zip(ref, grads))
out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
distributed.shutdown()
print(json.dumps(out))
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_parallel_processes(tmp: str) -> list:
    """(d) and (e) started together, in the background of (a): two controller
    processes joined through ``initialize`` (LLMC_COORDINATOR on 127.0.0.1),
    each owning one 1B-class panel model on the card (16 tokens), and a
    one-process gloo + NCCL group running a consensus-1b training step with
    and without the group. :func:`finish_parallel_processes` collects them."""
    here = os.path.dirname(os.path.abspath(__file__))
    env0 = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = os.path.join(tmp, "par_worker.py")
    nccl = os.path.join(tmp, "nccl_worker.py")
    with open(script, "w") as f:
        f.write(PAR_WORKER)
    with open(nccl, "w") as f:
        f.write(NCCL_WORKER)
    argv = ["--models", "gpu:consensus-1b,gpu:llama-3.2-1b", "--judge", "gpu:consensus-1b",
            "--json", "--no-save", "--max-tokens", "16", PROMPT]
    port, port_e = _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(env0, LLMC_COORDINATOR=f"127.0.0.1:{port}", LLMC_NUM_PROCESSES="2",
                   LLMC_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, script, tmp, json.dumps(argv)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=here))
    procs.append(subprocess.Popen([sys.executable, nccl, str(port_e)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env0, cwd=here))
    return procs


def finish_parallel_processes(procs: list) -> tuple:
    """Wait for :func:`start_parallel_processes`' three processes (killing all
    of them on a timeout or a failure): ((d)'s two documents, (e)'s)."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"parallel: process {i} exit {rc}: {out[-600:]} {err[-1500:]}")
    docs = [json.loads(o[1].strip().splitlines()[-1]) for o in outs]
    return docs[:2], docs[2]


PAR_POOL_MB = 2048.0  # the tp 2 engine's KV pool: 2,048 MB over its two shards
PAR_TOKENS = 32        # (f): tokens a batched stream
PAR_SPEC_TOKENS = 48   # (i)


def gated_batcher(engine, **kw):
    """A batcher whose scheduler waits on a gate: submissions queued before
    the gate opens form one admission wave."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    gate = threading.Event()
    real_loop = ContinuousBatcher._loop

    def gated(self):
        gate.wait(timeout=300)
        real_loop(self)

    ContinuousBatcher._loop = gated
    try:
        b = ContinuousBatcher(engine, **kw)
    finally:
        ContinuousBatcher._loop = real_loop
    return b, gate


def par_waves(torch, engine, waves: list, n: int) -> tuple:
    """Each wave of prompt ids through its own gated ``ContinuousBatcher``
    (max_batch 4) over ``engine``, ``n`` greedy tokens a stream: the streams'
    tokens, each wave's snapshot and wall."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    s = SamplingParams(max_new_tokens=n, ignore_eos=True)
    tokens, snaps, walls = [], [], []
    for wave in waves:
        b, gate = gated_batcher(engine, max_batch=4)
        try:
            t0 = time.monotonic()
            futs = [b.submit_ids(list(p), s) for p in wave]
            gate.set()
            tokens += [f.result(timeout=600).token_ids for f in futs]
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            snaps.append(b.snapshot())
        finally:
            b.close()
        del b
        release_memory(torch)
    return tokens, snaps, walls


def parallel_serving(torch, fa, da, base, sharded, ids: list, seed: int, out: dict,
                     recs: dict) -> dict:
    """(f)-(i): serving over the tp 2 engine of (a) (its KV pool on), the tp 1
    engine beside it. (f) a ``ContinuousBatcher(max_batch=4)`` over tp 2: 4
    prompts sharing (a)'s 350-token prompt (the shared prefix), then 4
    unrelated ones of 300-420 tokens (flash at B = 4, ragged rows), 32
    tokens each, against the same waves on tp 1 (the near-tie rule), each
    shard's launches counted at its head slice. (g) a 1,500-token prompt
    through the tp 2 pool: its miss, then its hit (prefill ms by CUDA
    events, the median of 3; the hit's tokens against the miss's). (h) a ``KVHandoff`` from
    the tp 1 engine (the prefill role, its own tree) into the tp 2 pool: the
    gathered shards joined, bitwise equal to the tp 1 prefill's bytes. (i)
    prompt lookup on a ~2,000-token judge prompt over tp 2, against the
    plain tp 2 decode."""
    from llm_consensus_tpu_torch.consensus import render_judge_prompt
    from llm_consensus_tpu_torch.engine import PromptLookupDrafter, SamplingParams, SpeculativeEngine
    from llm_consensus_tpu_torch.engine.handoff import KVHandoff
    from llm_consensus_tpu_torch.models.transformer import ShardGroup
    from llm_consensus_tpu_torch.ops.quant import kv_seq_axis
    from llm_consensus_tpu_torch.providers import Response

    cfg, tp, row = base.cfg, 2, {}
    bos = base.tokenizer.bos_id
    shared = [ids + random_ids(torch, seed + 40 + i, 8) for i in range(4)]
    unrelated = [random_ids(torch, seed + 50 + i, n, bos) for i, n in enumerate((419, 379, 339, 299))]
    t0 = time.monotonic()
    for c in (fa.LAUNCHES, da.LAUNCHES, da.LAUNCHES_STATE):
        c.reset()
    with ShardLaunches(tp) as log2:
        got, snaps, walls = par_waves(torch, sharded, [shared, unrelated], PAR_TOKENS)
    launches = {"flash_attention": fa.LAUNCHES.count, "decode_attention": da.LAUNCHES.count,
                "decode_attention_state": da.LAUNCHES_STATE.count}
    out["memory_gb"]["tp2 batcher peak"] = torch.cuda.max_memory_allocated() / 1e9
    ref, ref_snaps, ref_walls = par_waves(torch, base, [shared, unrelated], PAR_TOKENS)
    by = log2.by_shard()
    b4 = {"flash_attention": log2.at_batch("flash_attention", 4),
          "decode_attention": log2.at_batch("decode_attention", 4),
          "decode_attention_state": log2.at_batch("decode_attention_state", 4)}
    heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
    checks = [greedy_check(torch, base, f"parallel (f) stream {i} tp 2 against tp 1",
                           p, g, r) for i, (p, g, r) in enumerate(zip(shared + unrelated, got, ref))]
    row["f"] = {"launches": launches, "by_shard": by, "at_b4": b4, "walls_s": walls,
                "tp1_walls_s": ref_walls, "prefix_len": [sn["prefix_len"] for sn in snaps],
                "pool_decode_tokens_per_s": [sn["decode_tokens"] / max(sn["decode_s"], 1e-9)
                                             for sn in snaps],
                "tp1_pool_decode_tokens_per_s": [sn["decode_tokens"] / max(sn["decode_s"], 1e-9)
                                                 for sn in ref_snaps],
                "tokens": checks, "wall_s": time.monotonic() - t0}
    log(f"parallel (f): tp 2 batcher, waves {[round(w, 2) for w in walls]} s (tp 1 "
        f"{[round(w, 2) for w in ref_walls]}), prefix {row['f']['prefix_len']}; by shard: flash "
        f"{by['flash_attention']}, decode {by['decode_attention']}, state "
        f"{by['decode_attention_state']} at Hq/Hkv {heads}; at B = 4: {b4}; counters {launches}")
    if (snaps[0]["prefix_len"] <= 0 or snaps[1]["prefix_len"] != 0
            or any(by[k + "_heads"] != [heads] for k in launches)
            or any(len(set(by[k])) != 1 or min(by[k]) <= 0 for k in launches)
            or any(launches[k] != sum(by[k]) for k in ("flash_attention", "decode_attention_state"))
            or launches["decode_attention"] != sum(by["decode_attention"])
            + sum(by["decode_attention_state"])
            or min(b4.values()) <= 0 or b4["flash_attention"] != tp * cfg.n_layers):
        raise AssertionError(f"parallel (f): {row['f']}")
    recs["flash_attention_tp2_b4"]["launches"] = b4["flash_attention"]
    recs["decode_attention_tp2_b4"]["launches"] = b4["decode_attention"]
    recs["decode_attention_state_tp2_b4"]["launches"] = b4["decode_attention_state"]

    # (g) a pool hit over tp 2 against its miss.
    pool = sharded._kv_pool
    long_ids = random_ids(torch, seed + 60, 1500, bos)
    s16 = SamplingParams(max_new_tokens=16, ignore_eos=True)
    with torch.inference_mode():
        miss_ms = median_ms(torch, lambda: sharded._prefill_ids(long_ids), 3)
        miss = sharded.generate_ids(long_ids, s16).token_ids  # publishes the prompt's blocks
        hits0 = pool.stats()["hits"]
        hit_ms = median_ms(torch, lambda: sharded._prefill_ids(long_ids), 3)
    hit = sharded.generate_ids(long_ids, s16).token_ids
    stats = pool.stats()
    row["g"] = {"miss_prefill_ms": miss_ms, "hit_prefill_ms": hit_ms,
                "hits": stats["hits"] - hits0, "hit_tokens": stats["hit_tokens"],
                "arenas": len(pool._arena), "arena_gb": pool.arena_bytes / 1e9,
                "tokens": greedy_check(torch, base, "parallel (g) tp 2 pool hit against its miss",
                                       long_ids, hit, miss)}
    log(f"parallel (g): tp 2 pool ({len(pool._arena)} arenas, {pool.arena_bytes / 1e9:.2f} GB): "
        f"{len(long_ids)}-token prefill {miss_ms:.1f} ms on a miss, {hit_ms:.1f} ms on a hit "
        f"({row['g']['hits']} hits)")
    if row["g"]["hits"] < 4 or not hit_ms < miss_ms:
        raise AssertionError(f"parallel (g): {row['g']}")

    # (h) a handoff from the tp 1 engine into the tp 2 pool: the bytes.
    h_ids = random_ids(torch, seed + 61, 1200, bos)
    with torch.inference_mode():
        _lg, ref_cache, _w = base.admission_session([list(h_ids)]).run()
    # The tp 1 engine holds the tree the tp 2 engine was cut from.
    h = KVHandoff(base, sharded, version=sharded.weight_version, name="parallel")
    try:
        t0 = time.monotonic()
        ok, truncated = h.run(list(h_ids), priority=0)
        h_wall = time.monotonic() - t0
        snap = h.snapshot()
    finally:
        h.close()
    span = (len(h_ids) // pool.block_size) * pool.block_size
    with torch.inference_mode():
        n, gathered = pool.lookup(list(h_ids) + [65], min_tokens=1)
        joined = ShardGroup.join_cache(gathered, base.device) if n else None
        equal = n == span and all(
            torch.equal(a.narrow(kv_seq_axis(a), 0, span), b.narrow(kv_seq_axis(b), 0, span))
            for side in ("k", "v") for a, b in ((joined[side], ref_cache[side]),))
    row["h"] = {"ok": ok, "truncated": truncated, "span": span, "gathered": n,
                "bitwise_equal": equal, "handoff_bytes": snap["handoff_bytes"],
                "handoff_blocks": pool.stats()["handoff_blocks"], "wall_s": h_wall}
    log(f"parallel (h): handoff tp 1 → tp 2 pool of {span} tokens in {h_wall:.2f} s, "
        f"{snap['handoff_bytes'] / 1e6:.1f} MB, gathered {n}, bitwise equal {equal}")
    del gathered, joined, ref_cache
    if not (ok and not truncated and equal):
        raise AssertionError(f"parallel (h): {row['h']}")

    # (i) prompt lookup over the tp 2 judge.
    answer = sharded.tokenizer.decode(got[0])
    judge = render_judge_prompt(PROMPT, [Response("gpu:llama-3-8b", answer, "gpu"),
                                         Response("gpu:consensus-1b", PROMPT[:400], "gpu")])
    s48 = SamplingParams(max_new_tokens=PAR_SPEC_TOKENS, ignore_eos=True)
    plain = sharded.generate(judge, s48)
    spec = SpeculativeEngine(sharded, PromptLookupDrafter(), k=SPEC_K, governor=False)
    res = spec.generate(judge, s48)
    jids = sharded._budget_prompt(sharded.tokenizer.encode(judge), PAR_SPEC_TOKENS)[0]
    row["i"] = {"prompt_tokens": len(jids), "rounds": spec.stats["rounds"],
                "mean_accepted": spec.mean_accepted, "tokens_per_s": spec_rate(res),
                "plain_tokens_per_s": spec_rate(plain),
                "tokens": greedy_check(torch, base, "parallel (i) lookup over tp 2", jids,
                                       res.token_ids, plain.token_ids)}
    log(f"parallel (i): lookup over tp 2 on a {len(jids)}-token judge prompt: mean accepted "
        f"{spec.mean_accepted:.3f} over {spec.stats['rounds']} rounds, "
        f"{row['i']['tokens_per_s']:.2f} tokens/s against plain {row['i']['plain_tokens_per_s']:.2f}")
    if spec.stats["rounds"] <= 0 or spec.mean_accepted <= 1.0:
        raise AssertionError(f"parallel (i): {row['i']}")
    return row


def parallel_swap(torch, seed: int, out: dict) -> dict:
    """(j): consensus-1b bf16 on tp 2 swapped to seed + 1 weights: its tokens
    equal a fresh tp 2 engine's on those weights; the swap's preparation
    wall and the memory the double buffer holds."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

    cfg = get_config("consensus-1b")
    mesh = make_mesh({"dp": 1, "tp": 2}, virtual_devices(2, "cuda"))
    t0 = time.monotonic()
    gb0 = gb(torch)
    eng = Engine(cfg, seed=0, mesh=mesh)
    built = gb(torch)
    ids = random_ids(torch, seed + 70, 349, eng.tokenizer.bos_id)
    s32 = SamplingParams(max_new_tokens=32, ignore_eos=True)
    before = eng.generate_ids(ids, s32).token_ids
    new = init_params(cfg, seed + 1, device=eng.device)
    eng.swap_weights(1, new)
    swapped = eng.generate_ids(ids, s32).token_ids
    after_swap = gb(torch)
    fresh = Engine(cfg, new, mesh=make_mesh({"dp": 1, "tp": 2}, virtual_devices(2, "cuda")))
    want = fresh.generate_ids(ids, s32).token_ids
    stats = eng.swap_stats()
    row = {"equal_to_fresh": swapped == want, "changed": swapped != before,
           "version": stats["weight_version"], "prep_ms": stats["last_prep_ms"],
           "memory_gb": {"built": built - gb0, "after swap": after_swap - gb0},
           "wall_s": time.monotonic() - t0}
    log(f"parallel (j): consensus-1b tp 2 swapped to seed + 1 in {stats['last_prep_ms']:.1f} ms "
        f"of preparation; tokens equal to a fresh tp 2 engine {row['equal_to_fresh']}, changed "
        f"{row['changed']}; {row['memory_gb']}")
    if not row["equal_to_fresh"] or not row["changed"] or row["version"] != 1:
        raise AssertionError(f"parallel (j): {row}")
    del eng, fresh, new
    release_memory(torch)
    return row


def parallel_tp2(torch, fa, da, seed: int, out: dict, recs: dict) -> dict:
    """(a): llama-3-8b bf16 on a tp 2 mesh of two positions of the card
    against the tp = 1 engine on the same seed-0 weights (the tp 2 engine's
    KV pool on, for (g) and (h)); then (f)-(i) over the same two engines."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

    cfg = get_config("llama-3-8b")
    t0 = time.monotonic()
    base = Engine(cfg, seed=0)
    out["memory_gb"]["tp1 built"] = gb(torch)
    tp = 2
    sharded = Engine(cfg, base.params, kv_pool=True, kv_pool_mb=PAR_POOL_MB,
                     mesh=make_mesh({"dp": 1, "tp": tp}, virtual_devices(tp, "cuda")))
    out["memory_gb"]["tp2 built"] = gb(torch)
    out["walls_s"]["builds"] = time.monotonic() - t0
    ids = random_ids(torch, seed + 30, 349, base.tokenizer.bos_id)
    s64 = SamplingParams(max_new_tokens=64, ignore_eos=True)
    t0 = time.monotonic()
    ref = base.generate_ids(ids, s64).token_ids
    out["walls_s"]["tp1 generate"] = time.monotonic() - t0
    fa.LAUNCHES.reset()
    da.LAUNCHES.reset()
    t0 = time.monotonic()
    with ShardLaunches(tp) as shard_log:
        got = sharded.generate_ids(ids, s64).token_ids
    torch.cuda.synchronize()
    out["walls_s"]["tp2 generate"] = time.monotonic() - t0
    launches = {"flash_attention": fa.LAUNCHES.count, "decode_attention": da.LAUNCHES.count}
    per_shard = shard_log.by_shard()
    row = {"launches": launches, "by_shard": per_shard,
           "tokens": greedy_check(torch, base, "parallel (a) tp 2 against tp 1", ids, got, ref)}
    heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
    if (per_shard["flash_attention_heads"] != [heads]
            or per_shard["decode_attention_heads"] != [heads]
            or per_shard["flash_attention"] != [cfg.n_layers] * tp
            or min(per_shard["decode_attention"]) <= 0
            or launches["flash_attention"] != sum(per_shard["flash_attention"])
            or launches["decode_attention"] != sum(per_shard["decode_attention"])):
        raise AssertionError(f"parallel (a): launches by shard {per_shard}, counters {launches}")
    recs["flash_attention_tp2"]["launches"] = launches["flash_attention"]
    recs["decode_attention_tp2"]["launches"] = launches["decode_attention"]
    log(f"parallel (a): tp 2 on 2 positions of the card: flash {per_shard['flash_attention']} "
        f"and decode {per_shard['decode_attention']} launches by shard at Hq/Hkv {heads}; "
        f"memory {out['memory_gb']}")
    t0 = time.monotonic()
    out.update(parallel_serving(torch, fa, da, base, sharded, ids, seed, out, recs))
    out["walls_s"]["serving (f)-(i)"] = time.monotonic() - t0
    del sharded
    release_memory(torch)

    # The other head-slice rows on the main path: tp 8 (Hq 4 / Hkv 1) in
    # bf16, and tp 2 over the int8 cache against tp 1 over the int8 cache;
    # 16 tokens each (no rate is read here).
    s16 = SamplingParams(max_new_tokens=16, ignore_eos=True)
    for tag, n, kv_quant, counter, key in (
            ("tp 8", 8, None, da.LAUNCHES, "decode_attention_tp8"),
            ("tp 2, int8 cache", 2, "int8", da.LAUNCHES_INT8, "decode_attention_int8_tp2")):
        ref_engine = base if kv_quant is None else Engine(cfg, base.params, kv_quant=kv_quant)
        want = ref_engine.generate_ids(ids, s16).token_ids
        eng = Engine(cfg, base.params, kv_quant=kv_quant,
                     mesh=make_mesh({"dp": 1, "tp": n}, virtual_devices(n, "cuda")))
        out["memory_gb"][f"{tag} built"] = gb(torch)
        fa.LAUNCHES.reset()
        counter.reset()
        with ShardLaunches(n) as shard_log:
            got = eng.generate_ids(ids, s16).token_ids
        torch.cuda.synchronize()
        by = shard_log.by_shard()
        counts = {"flash_attention": fa.LAUNCHES.count, key: counter.count}
        hq_hkv = (cfg.n_heads // n, cfg.n_kv_heads // n)
        row[tag] = {"launches": counts, "by_shard": by, "tokens": greedy_check(
            torch, ref_engine, f"parallel (a) {tag} against tp 1", ids, got, want)}
        if (by["flash_attention"] != [cfg.n_layers] * n or min(by["decode_attention"]) <= 0
                or by["decode_attention_heads"] != [hq_hkv]
                or counts[key] != sum(by["decode_attention"])
                or counts["flash_attention"] != sum(by["flash_attention"])):
            raise AssertionError(f"parallel (a) {tag}: {row[tag]}")
        if n == 8:
            recs["flash_attention_tp8"]["launches"] = counts["flash_attention"]
        recs[key]["launches"] = counts[key]
        log(f"parallel (a) {tag}: flash {by['flash_attention']} and decode "
            f"{by['decode_attention']} launches by shard at Hq/Hkv {hq_hkv}")
        del eng, ref_engine
        release_memory(torch)
    del base
    release_memory(torch)
    return row


def parallel_cli(torch, fa, da) -> dict:
    """(c): the slice's CLI with the provider given 4 positions of the card:
    panel and judge on disjoint positions (tp 2 each), every model
    answers, the kernels launched."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main
    from llm_consensus_tpu_torch.parallel import virtual_devices
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    fresh_planes()
    t0 = time.monotonic()
    prov = GPUProvider(devices=virtual_devices(4, "cuda"), prefix_cache=False)
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    for c in counters.values():
        c.reset()
    cli_out, cli_err = io.StringIO(), io.StringIO()
    models = ["gpu:llama-3-8b", "gpu:consensus-1b"]
    rc = cli_main(["--models", ",".join(models), "--judge", "gpu:llama-3-8b", "--json",
                   "--max-tokens", CLI_TOKENS, PROMPT], factory=lambda m: prov,
                  stdout=cli_out, stderr=cli_err, install_signal_handlers=False)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"parallel (c): exit {rc}: {cli_err.getvalue()[-800:]}")
    doc = json.loads(cli_out.getvalue())
    places = {m: [d.id for d in prov.placement(m).devices.flat] for m in models}
    row = {"placements": places, "launches": {n: c.count for n, c in counters.items()},
           "answers": [r["model"] for r in doc["responses"]],
           "memory_gb": gb(torch), "wall_s": time.monotonic() - t0}
    log(f"parallel (c): placements {places}, answers {row['answers']}, launches "
        f"{row['launches']}, {row['wall_s']:.1f} s, {row['memory_gb']:.2f} GB")
    if (set(places[models[0]]) & set(places[models[1]]) or len(doc["responses"]) != 2
            or not doc.get("consensus") or min(row["launches"].values()) <= 0):
        raise AssertionError(f"parallel (c): {row}")
    prov.release()
    del prov
    release_memory(torch)
    return row


def run_parallel(torch, fa, da, card: str, seed: int, recs: dict) -> dict:
    """Phase 8l: ``parallel/`` on the one card, several mesh positions backed
    by ``cuda:0`` (``virtual_devices``). (a) llama-3-8b bf16 at full width on
    ``make_mesh({"dp": 1, "tp": 2})``: a 350-token prompt and 64 greedy
    tokens against the tp = 1 engine on the same seed-0 weights (equal or
    the near-tie rule), the flash and decode launches counted by shard at
    Hq 16 / Hkv 4. (b) sequence-parallel prefill at sp 2 of a 1,024-token
    prompt (ring attention): its last logits within BATCH_LOGIT_TOL of the
    tp = 1 engine's chunked prefill, and 16 tokens decoded from the
    ring-built cache. (c) the slice's CLI with the provider given 4
    positions: panel and judge on disjoint positions (tp 2 each), every
    model answers, the kernels launched. (d) two controller processes, each
    owning one 1B-class panel model, the results merged over gloo: both
    end with the same merged result. (e) a one-process gloo + NCCL group:
    a consensus-1b training step whose gradient all-reduce goes through
    NCCL equals the step without a group. (f)-(i) serve over (a)'s tp 2
    engine (:func:`parallel_serving`: the batcher with its shared prefix, a
    KV-pool hit, a handoff from tp 1 into the tp 2 pool, prompt lookup);
    (j) swaps a tp 2 consensus-1b to seed + 1 weights
    (:func:`parallel_swap`). Prints a ``{"parallel": ...}`` line."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

    t_phase = time.monotonic()
    out: dict = {"memory_gb": {}, "walls_s": {}}
    release_memory(torch)
    # (d) and (e) run in child processes beside (a) and (c) (their ~24 GB fit
    # beside either one's ~35 GB at most; (b), ~52 GB, waits for them).
    tmp = tempfile.mkdtemp(prefix="chip-smoke-parallel-")
    procs = start_parallel_processes(tmp)
    try:
        out["a"] = parallel_tp2(torch, fa, da, seed, out, recs)
        t0 = time.monotonic()
        out["j"] = parallel_swap(torch, seed, out)
        out["walls_s"]["swap (j)"] = time.monotonic() - t0
        out["c"] = parallel_cli(torch, fa, da)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        d_docs, e_doc = finish_parallel_processes(procs)
        out["walls_s"]["processes"] = time.monotonic() - t_phase
        results = []
        for rank in range(2):
            with open(os.path.join(tmp, f"result-{rank}.json")) as f:
                results.append(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = get_config("llama-3-8b")
    base = Engine(cfg, seed=0)

    # (b) sequence-parallel prefill of 1,024 tokens against the chunked path.
    import llm_consensus_tpu_torch.engine.engine as eng_mod

    t0 = time.monotonic()
    sp = Engine(cfg, base.params, mesh=make_mesh({"sp": 2}, virtual_devices(2, "cuda")))
    out["memory_gb"]["sp2 built"] = gb(torch)
    long_ids = random_ids(torch, seed + 31, 1023, base.tokenizer.bos_id)
    rings = []
    real_ring = eng_mod.forward_ring_prefill
    eng_mod.forward_ring_prefill = lambda *a, **k: rings.append(1) or real_ring(*a, **k)
    try:
        with torch.inference_mode():
            sp_logits, _c = sp._prefill_ids(long_ids)
            del _c
            ref_logits, _c = base._prefill_ids(long_ids)
            del _c
        torch.cuda.synchronize()
    finally:
        eng_mod.forward_ring_prefill = real_ring
    diff = (sp_logits.float() - ref_logits.float()).abs().max().item()
    s16 = SamplingParams(max_new_tokens=16, ignore_eos=True)
    got16 = sp.generate_ids(long_ids, s16).token_ids
    ref16 = base.generate_ids(long_ids, s16).token_ids
    out["walls_s"]["sp"] = time.monotonic() - t0
    out["b"] = {"ring_prefills": len(rings), "max_logit_diff": diff,
                "tokens": greedy_check(torch, base, "parallel (b) sp 2 against chunked", long_ids,
                                       got16, ref16)}
    log(f"parallel (b): sp 2 ring prefill of {len(long_ids)} tokens ({len(rings)} ring "
        f"prefills), last logits {diff:.4f} from the chunked path (tol {BATCH_LOGIT_TOL})")
    if len(rings) < 1 or diff > BATCH_LOGIT_TOL:
        raise AssertionError(f"parallel (b): {out['b']}")
    del sp, base
    release_memory(torch)

    merged = json.loads(results[0])
    out["d"] = {"equal": results[0] == results[1], "counts": [d["count"] for d in d_docs],
                "answers": sorted(r["model"] for r in merged["responses"])}
    out["e"] = e_doc
    log(f"parallel (d): two controllers, merged results equal {out['d']['equal']}, answers "
        f"{out['d']['answers']}; (e) backend {e_doc.get('backend')}, all-reduces "
        f"{e_doc['all_reduces']} on {e_doc['all_reduce_devices']}, grads equal "
        f"{e_doc['grads_equal']}, loss {e_doc['alone']['loss']:.6f} / "
        f"{e_doc['grouped']['loss']:.6f}; done {out['walls_s']['processes']:.1f} s into the phase")
    if (not out["d"]["equal"] or out["d"]["counts"] != [2, 2]
            or out["d"]["answers"] != ["gpu:consensus-1b", "gpu:llama-3.2-1b"]
            or not merged.get("consensus")):
        raise AssertionError(f"parallel (d): {out['d']}")
    if (not e_doc["grads_equal"] or e_doc["all_reduces"] <= 0
            or e_doc["all_reduce_devices"] != ["cuda"] or "nccl" not in e_doc["backend"]
            or e_doc["alone"]["loss"] != e_doc["grouped"]["loss"]):
        raise AssertionError(f"parallel (e): {e_doc}")
    out["wall_s"] = time.monotonic() - t_phase
    log(f"parallel: phase {out['wall_s']:.1f} s")
    print(json.dumps({"parallel": out, "card": card}, default=str), flush=True)
    return out


# -- phase 8m: the runtime sanitizer over the chaos and disaggregated paths ----

SANITIZE_MODEL = "consensus-1b"
SANITIZE_TOKENS = "24"
# (a) the batched, pooled, journaled, integrity-checked CLI through an
# injected crash with the sanitizer on; (c) the same run with it off.
SANITIZE_CHAOS_ENV = {"LLMC_MAX_BATCH": "4", "LLMC_KV_POOL": "1", "LLMC_JOURNAL": "1",
                      "LLMC_INTEGRITY": "1", "LLMC_FAULTS": "crash@chunk=3",
                      "LLMC_FAULTS_SEED": "7"}
# (b) ``serve --disagg`` over consensus-1b alone: four ~700-token requests,
# so every panel and judge prompt holds a 512-token prefill chunk and takes a
# handoff on one card.
SANITIZE_DISAGG_ARGS = ["--models", f"gpu:{SANITIZE_MODEL}", "--judge", f"gpu:{SANITIZE_MODEL}",
                        "--max-batch", "4", "--max-tokens", "16", "--cache-size", "0",
                        "--port", "0", "--disagg"]
SANITIZE_CHILD_S = 420  # one child's limit: it is killed after it


def sanitize_streams(slog) -> list:
    """Every stream of ``slog`` that finished: its preset, prompt ids,
    greedy tokens and sampling bounds (a replayed stream's tokens include
    the ones it replayed)."""
    out = []
    for it in slog.items:
        fut = it.future
        if fut.done() and not fut.cancelled() and fut.exception() is None:
            out.append({"preset": it.engine.cfg.name, "prompt_ids": list(it.prompt_ids),
                        "tokens": list(fut.result().token_ids),
                        "max_new": it.sampling.max_new_tokens,
                        "ignore_eos": it.sampling.ignore_eos})
    return out


def sanitize_compare(torch, provider, mine: list, other: list) -> dict:
    """The sanitized run's streams (``other``) against this run's
    (``mine``), on this run's engines: equal, or near-ties under teacher
    forcing; a stream this run never had (a judge prompt whose panel answers
    landed in another order) is held to the engine's single-stream greedy
    tokens."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    ref = {(s["preset"], tuple(s["prompt_ids"])): s["tokens"] for s in mine}
    engines = provider.engines()
    rows, seen, equal, unmatched = [], set(), 0, 0
    for s in other:
        key = (s["preset"], tuple(s["prompt_ids"]))
        if key in seen:
            continue
        seen.add(key)
        engine = engines[s["preset"]]
        want = ref.get(key)
        if want is None:
            unmatched += 1
            want = engine.generate_ids(list(key[1]), SamplingParams(
                max_new_tokens=s["max_new"], ignore_eos=s["ignore_eos"])).token_ids
        if s["tokens"] == want:
            equal += 1
        else:
            rows.append(greedy_check(torch, engine, f"sanitize (a) {s['preset']} stream",
                                     list(key[1]), s["tokens"], want))
    return {"streams": len(seen), "equal": equal, "near_ties": rows,
            "single_stream_refs": unmatched}


def sanitize_chaos(torch, fa, da, tmp: str, kind: str, against: str) -> dict:
    """Child (a) or (c): the port's CLI in this process, panel 4 x
    consensus-1b, judge consensus-1b, bf16, the slice's prompt, 24 tokens,
    under ``SANITIZE_CHAOS_ENV``. Its finished streams go to
    ``<tmp>/<kind>.streams.json``; with ``against`` (another child's
    streams) they are compared as :func:`sanitize_compare` does."""
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    argv = ["--models", ",".join([f"gpu:{SANITIZE_MODEL}"] * 4), "--judge",
            f"gpu:{SANITIZE_MODEL}", "--max-tokens", SANITIZE_TOKENS, "--json",
            "--data-dir", os.path.join(tmp, kind), PROMPT]
    with StreamLog() as slog:
        call = cli_call(torch, counters, SANITIZE_CHAOS_ENV, argv)
    out = {"rc": call["rc"], "wall_s": call["wall_s"], "launches": call["launches"],
           "peak_gb": call["peak_gb"]}
    if call["rc"] != 0:
        raise AssertionError(f"CLI exit {call['rc']}: {call['err'][-3000:]}")
    doc = json.loads(call["out"])
    (provider,) = [p for p in GPUProvider._shared.values() if p.journal is not None]
    out["restarts"] = provider.recovery_stats()["restarts"]
    out["answers"] = {"consensus": doc["consensus"],
                      "responses": sorted(r["content"] for r in doc["responses"]),
                      "failed_models": doc.get("failed_models") or []}
    streams = sanitize_streams(slog)
    with open(os.path.join(tmp, f"{kind}.streams.json"), "w", encoding="utf-8") as f:
        json.dump(streams, f)
    if against:
        with open(against, encoding="utf-8") as f:
            out["against"] = sanitize_compare(torch, provider, streams, json.load(f))
    log(f"sanitize ({kind}): CLI exit 0 in {call['wall_s']:.2f} s, launches {call['launches']}, "
        f"restarts {out['restarts']}, {len(streams)} streams")
    return out


def sanitize_disagg(torch, fa, da, tmp: str) -> dict:
    """Child (b): ``serve --disagg`` in this process on one card, four
    concurrent requests whose prompts take a handoff; every request must be
    answered."""
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    stop, err, rc = threading.Event(), io.StringIO(), []
    with set_environ(DISAGG_ENV), ProviderCatch() as catch:
        server, port = serve_in_process(SANITIZE_DISAGG_ARGS, os.path.join(tmp, "disagg"), stop,
                                        err, rc, "sanitize (b)")
        try:
            provider = catch.providers[0]
            bodies = [{"prompt": f"Request {i} of four. {PROMPT} {PROMPT}"} for i in range(4)]
            for c in counters.values():
                c.reset()
            t0 = time.monotonic()
            answers = gw_fire(port, bodies)
            wall = time.monotonic() - t0
            launches = {name: c.count for name, c in counters.items()}
            stats = provider.disagg_stats()
        finally:
            stop.set()
            server.join(120)
    answered = 0
    for status, _h, data, _wall, _sse in answers:
        doc = json.loads(data) if status == 200 else {}
        answered += bool(doc.get("consensus")) and not doc.get("failed_models")
    out = {"rc": rc[0] if rc else None, "wall_s": wall, "launches": launches,
           "answered": answered, "handoff": stats.get(SANITIZE_MODEL)}
    log(f"sanitize (disagg): {answered} of 4 answered in {wall:.2f} s, launches {launches}, "
        f"handoff {out['handoff']}, server exit {out['rc']}")
    return out


def sanitize_child(torch, fa, da, kind: str, tmp: str, against: str) -> int:
    """One child of the sanitize phase, in a process of its own (the
    sanitizer resolves ``LLMC_SANITIZE`` once per process): runs ``kind``
    and prints one ``{"sanitize_child": ...}`` line with the sanitizer's
    counts (and its rendered report when it found anything)."""
    from llm_consensus_tpu_torch.analysis import sanitizer

    out = {"child": kind, "sanitize": sanitizer.enabled()}
    t0 = time.monotonic()
    try:
        if kind == "disagg":
            out.update(sanitize_disagg(torch, fa, da, tmp))
        else:
            out.update(sanitize_chaos(torch, fa, da, tmp, kind, against))
    except BaseException as err:  # noqa: BLE001 — reported on the line, then the exit code
        out["error"] = f"{type(err).__name__}: {err}"[-4000:]
    rep = sanitizer.report()
    if rep is not None:
        out["sanitizer"] = {"locks": len(rep["locks"]), "edges": len(rep["edges"]),
                            "cycles": len(rep["cycles"]), "violations": len(rep["violations"])}
        if rep["cycles"] or rep["violations"]:
            out["report"] = sanitizer.render_report(rep)
    out["child_wall_s"] = time.monotonic() - t0
    print(json.dumps({"sanitize_child": out}, default=str), flush=True)
    return 1 if "error" in out else 0


def sanitize_spawn(kind: str, tmp: str, sanitize: bool, against: str = "") -> dict:
    """Run one child (``python3 chip_smoke.py --sanitize-child kind``) with
    ``LLMC_SANITIZE=1`` or without it, echo its log lines and return its
    ``sanitize_child`` record; kill it after ``SANITIZE_CHILD_S``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "LLMC_SANITIZE"}
    if sanitize:
        env["LLMC_SANITIZE"] = "1"
    argv = [sys.executable, os.path.join(here, "chip_smoke.py"), "--sanitize-child", kind,
            "--sanitize-dir", tmp] + (["--sanitize-against", against] if against else [])
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=here)
    try:
        stdout, stderr = proc.communicate(timeout=SANITIZE_CHILD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"sanitize ({kind}): the child ran past {SANITIZE_CHILD_S} s: "
                             f"{stdout[-2000:]} {stderr[-3000:]}")
    records = []
    for line in stdout.splitlines():
        if line.startswith('{"sanitize_child"'):
            records.append(json.loads(line)["sanitize_child"])
        else:
            log(f"  [{kind}] {line}")
    if proc.returncode != 0 or not records:
        raise AssertionError(f"sanitize ({kind}): child exit {proc.returncode}: {records} "
                             f"{stderr[-4000:]}")
    return records[-1]


def run_sanitize(torch, card: str, seed: int) -> dict:
    """Phase 8m: the runtime lock sanitizer (``LLMC_SANITIZE=1``) over the
    port's chaos and disaggregated serving paths on the card, in child
    processes: (a) the chaos CLI (:func:`sanitize_chaos`) through one
    injected crash and its replay; (b) ``serve --disagg`` with four handed-off
    requests; (c) (a) again without the sanitizer, the reference. Fails on a
    lock-order cycle or an off-lock access in (a) or (b) (printed with the
    first-observed stacks), a kernel of (a) that never launched, (a) or (c)
    without exactly one restart, an unanswered request in (b), or an (a)
    stream neither equal to (c)'s nor a near-tie. Prints a
    ``{"sanitize": ...}`` line."""
    t_phase = time.monotonic()
    fresh_planes()
    release_memory(torch)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sanitize-") as tmp:
        a = sanitize_spawn("chaos", tmp, True)
        b = sanitize_spawn("disagg", tmp, True)
        c = sanitize_spawn("reference", tmp, False, os.path.join(tmp, "chaos.streams.json"))
    for name, child in (("a", a), ("b", b)):
        counts = child.get("sanitizer")
        if not child["sanitize"] or counts is None:
            raise AssertionError(f"sanitize ({name}): the sanitizer was off: {child}")
        if counts["cycles"] or counts["violations"]:
            raise AssertionError(f"sanitize ({name}): {counts}\n{child.get('report', '')}")
    if c["sanitize"] or "sanitizer" in c:
        raise AssertionError(f"sanitize (c): the reference ran sanitized: {c}")
    if min(a["launches"].values()) <= 0:
        raise AssertionError(f"sanitize (a): a kernel never launched: {a['launches']}")
    for name, child in (("a", a), ("c", c)):
        if child["rc"] != 0 or child["restarts"] != 1 or child["answers"]["failed_models"]:
            raise AssertionError(f"sanitize ({name}): exit {child['rc']}, restarts "
                                 f"{child['restarts']}, {child['answers']}")
    handoff = b["handoff"] or {}
    if b["answered"] != 4 or handoff.get("completed", 0) < 4 or handoff.get("fallbacks"):
        raise AssertionError(f"sanitize (b): {b['answered']} of 4 answered, handoff {handoff}")
    out = {"a": a, "b": b, "c": c, "answers_equal": a["answers"] == c["answers"],
           "wall_ratio": a["wall_s"] / c["wall_s"], "wall_s": time.monotonic() - t_phase}
    log(f"sanitize: (a) {a['sanitizer']} in {a['wall_s']:.2f} s against {c['wall_s']:.2f} s "
        f"unsanitized ({out['wall_ratio']:.3f}x), launches {a['launches']}; (b) {b['sanitizer']}, "
        f"{b['answered']} of 4 answered in {b['wall_s']:.2f} s, handoff {handoff}; answers equal "
        f"{out['answers_equal']}, (a)'s streams against (c): {c['against']['equal']} equal, "
        f"{len(c['against']['near_ties'])} near-ties, {c['against']['single_stream_refs']} "
        f"held to single-stream; phase {out['wall_s']:.1f} s")
    print(json.dumps({"sanitize": out, "card": card}, default=str), flush=True)
    return out


PHASE_WALLS: dict = {}  # phase → seconds, in run order


@contextlib.contextmanager
def phase_wall(name: str):
    """Log the wall of one phase of ``main`` as it ends (and keep it for
    the summary line)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        PHASE_WALLS[name] = time.monotonic() - t0
        log(f"phase {name}: {PHASE_WALLS[name]:.1f} s")


def print_phase_walls(t_start: float) -> None:
    print(json.dumps({"phase_walls_s": PHASE_WALLS,
                      "total_s": time.monotonic() - t_start}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "mixtral", "telemetry", "modes",
                                        "session", "serving", "recovery", "kvpool", "spec",
                                        "gateway", "route", "disagg", "distill", "parallel",
                                        "sanitize"),
                    default="all")
    ap.add_argument("--seed", type=int, default=0)
    # One child of the sanitize phase (run_sanitize starts them).
    ap.add_argument("--sanitize-child", choices=("chaos", "disagg", "reference"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--sanitize-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--sanitize-against", default="", help=argparse.SUPPRESS)
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
    with phase_wall("build"):
        t0 = time.monotonic()
        build.ensure_built()
        log(f"build: {time.monotonic() - t0:.2f} s "
            f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")
    if args.sanitize_child:
        return sanitize_child(torch, fa, da, args.sanitize_child, args.sanitize_dir,
                              args.sanitize_against)

    flash_rec: dict = {}
    decode_rec: dict = {}
    int8_rec: dict = {}
    w8a8_rec: dict = {}
    state_recs: dict = {key: {} for key, _, _ in STATE_VARIANTS}
    rows16_recs: dict = {"decode_attention_b16": {}, "decode_attention_state_b16": {}}
    dh64_recs: dict = {"flash": {}, "decode": {}}
    head_recs: dict = {}  # the head-slice rows (check_head_slices)
    batch_recs: dict = {}  # generate_batch's decode row (check_decode_batch)
    records = [flash_rec, decode_rec, int8_rec, w8a8_rec, *state_recs.values(),
               *rows16_recs.values(), *dh64_recs.values()]
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
    if args.phase == "recovery":
        # The recovery phase alone: no ok line.
        run_recovery(torch, fa, da, card, args.seed)
        print(card, flush=True)
        return 0
    if args.phase == "kvpool":
        # The KV pool phase alone: no ok line.
        run_kvpool(torch, fa, da, card, args.seed)
        print(card, flush=True)
        return 0
    if args.phase == "serving":
        # The B = 16 kernel rows and the serving phase: no ok line.
        check_decode_rows16(torch, rows16_recs)
        run_serving(torch, fa, da, card, args.seed, rows16_recs)
        print(json.dumps({"kernels": list(rows16_recs.values())}), flush=True)
        print(card, flush=True)
        return 0
    if args.phase == "gateway":
        # The gateway phase alone: no ok line.
        with phase_wall("gateway"):
            run_gateway(torch, fa, da, card, args.seed)
        print_phase_walls(t_start)
        print(card, flush=True)
        return 0
    if args.phase == "route":
        # The route phase alone: no ok line.
        with phase_wall("route"):
            run_route(torch, fa, da, card, args.seed)
        print_phase_walls(t_start)
        print(card, flush=True)
        return 0
    if args.phase in ("disagg", "distill"):
        # The disagg phase, or the distill phase (on three runs of its own),
        # alone: no ok line.
        tmp = tempfile.mkdtemp(prefix="chip-smoke-flywheel-")
        try:
            with phase_wall(args.phase):
                if args.phase == "disagg":
                    run_disagg(torch, fa, da, card, args.seed, tmp)
                else:
                    run_distill(torch, card, args.seed, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print_phase_walls(t_start)
        print(card, flush=True)
        return 0
    if args.phase == "parallel":
        # The head-slice kernel rows and the parallel phase: no ok line.
        with phase_wall("kernels head slices"):
            check_head_slices(torch, head_recs)
            check_head_slices_b4(torch, head_recs)
        with phase_wall("parallel"):
            run_parallel(torch, fa, da, card, args.seed, head_recs)
        print_phase_walls(t_start)
        print(json.dumps({"kernels": list(head_recs.values())}), flush=True)
        print(card, flush=True)
        return 0
    if args.phase == "sanitize":
        # The sanitize phase alone: no ok line.
        with phase_wall("sanitize"):
            run_sanitize(torch, card, args.seed)
        print_phase_walls(t_start)
        print(card, flush=True)
        return 0
    if args.phase == "spec":
        # The dh 64 kernel rows and the spec phase: no ok line.
        with phase_wall("kernels dh 64"):
            check_kernels_dh64(torch, dh64_recs["flash"], dh64_recs["decode"])
        with phase_wall("spec"):
            run_spec(torch, fa, da, card, args.seed, dh64_recs)
        print_phase_walls(t_start)
        print(json.dumps({"kernels": list(dh64_recs.values())}), flush=True)
        print(card, flush=True)
        return 0
    with phase_wall("kernels"):
        check_flash(torch, flash_rec)
        check_decode(torch, decode_rec)
        check_kernels_dh64(torch, dh64_recs["flash"], dh64_recs["decode"])
        check_decode_int8(torch, int8_rec, w8a8_rec)
        check_decode_state(torch, state_recs)
        check_decode_rows16(torch, rows16_recs)
        check_head_slices(torch, head_recs)
        check_head_slices_b4(torch, head_recs)
        check_decode_batch(torch, batch_recs)
        check_int8_matmul(torch)
    records += list(head_recs.values()) + list(batch_recs.values())
    if args.phase == "kernels":
        # Kernel checks only: the main path did not run, so no ok line.
        print(json.dumps({"kernels": records}), flush=True)
        print(card, flush=True)
        return 0

    with phase_wall("small model"):
        check_small_model(torch, args.seed)
    with phase_wall("slice"):
        sl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES},
                       {}, "slice")
        flash_rec["launches"] = sl["launches"]["flash_attention"]
        decode_rec["launches"] = sl["launches"]["decode_attention"]
        if min(sl["launches"].values()) <= 0:
            raise AssertionError(f"a kernel of the slice never launched: {sl['launches']}")
    with phase_wall("chunked + profile"):
        run_chunked(torch, fa, da, sl["engines"]["llama-3-8b"], args.seed)
        engine = sl["engines"]["llama-3-8b"]
        ours = profile_decode(torch, engine, counter=da.LAUNCHES, steps=engine.stream_interval)
        # The bf16 decode is one launch per call: no merge kernel beside it.
        if ours:
            check_one_launch_per_step(ours, "decode_bf16_kernel", "decode_q8_kernel",
                                      da.LAUNCHES, engine.cfg.n_layers, "bf16 decode profile")
        del engine
        single_responses = sl["responses"]
        del sl
        release_engines(torch, {})

    with phase_wall("batched"):
        bsl = run_batched_slice(torch, fa, da, single_responses)
        state_recs["bf16"]["launches"] = bsl["launches"]["decode_attention_state"]
        run_batched_engine(torch, fa, da, bsl["engines"]["llama-3-8b"], state_recs)
        gb = batched_generate_batch(torch, fa, da, bsl["engines"]["llama-3-8b"], args.seed)
        batch_recs["decode_attention_batch_b4"]["launches"] = gb["launches"]["decode_attention"]
        modes = bsl["modes"]
        del bsl
        release_engines(torch, modes)
    with phase_wall("telemetry"):
        run_telemetry(torch, fa, da)
    with phase_wall("modes"):
        run_modes(torch, fa, da, card)
    with phase_wall("session"):
        run_session(torch, fa, da, card, args.seed)
    with phase_wall("serving"):
        run_serving(torch, fa, da, card, args.seed, rows16_recs)
    with phase_wall("recovery"):
        run_recovery(torch, fa, da, card, args.seed)
    with phase_wall("kvpool"):
        run_kvpool(torch, fa, da, card, args.seed)
    with phase_wall("spec"):
        run_spec(torch, fa, da, card, args.seed, dh64_recs)
    with phase_wall("gateway"):
        run_gateway(torch, fa, da, card, args.seed)
    with phase_wall("route"):
        run_route(torch, fa, da, card, args.seed)
    flywheel_tmp = tempfile.mkdtemp(prefix="chip-smoke-flywheel-")
    try:
        with phase_wall("disagg"):
            run_disagg(torch, fa, da, card, args.seed, flywheel_tmp)
        with phase_wall("distill"):
            run_distill(torch, card, args.seed, flywheel_tmp)
    finally:
        shutil.rmtree(flywheel_tmp, ignore_errors=True)
    with phase_wall("parallel"):
        run_parallel(torch, fa, da, card, args.seed, head_recs)
    with phase_wall("sanitize"):
        run_sanitize(torch, card, args.seed)

    with phase_wall("quantized slice"):
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
                                      da.LAUNCHES_INT8, engine.cfg.n_layers,
                                      "int8 decode profile")
        del engine
        modes = qsl["modes"]
        del qsl
        release_engines(torch, modes)

    with phase_wall("long context"):
        run_long_context(torch, fa, da, args.seed)
    with phase_wall("w8a8 + int4"):
        w8a8_rec["launches"] = run_engine_phase(
            torch, fa, da, "w8a8", da.LAUNCHES_W8A8, args.seed, quant="int8", kv_quant="int8",
            w8a8=True, decode_w8a8=True)
        run_engine_phase(torch, fa, da, "int4", da.LAUNCHES, args.seed, quant="int4")
    with phase_wall("mixtral"):
        run_mixtral(torch, fa, da, args.seed, mixtral_recs)
    log(f"all phases: {time.monotonic() - t_start:.1f} s")
    print_phase_walls(t_start)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
