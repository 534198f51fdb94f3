"""The ``gpu`` provider: on-device inference behind the Provider seam
(port of the single-stream half of ``llm_consensus_tpu/providers/tpu.py``).

Model names are ``gpu:<preset>`` for any preset of the catalog
(models/config.py), mixture-of-experts presets included, e.g.
``gpu:llama-3-8b``, ``gpu:mixtral-8x7b``, ``gpu:consensus-1b``,
``gpu:tiny-llama``. Engines are built lazily, once per preset, and shared
between panel and judge uses; distinct presets build concurrently under
per-preset locks. With ``checkpoint_dir`` each engine loads its weights
and tokenizer from ``<checkpoint_dir>/<preset>/`` (HF safetensors,
engine/checkpoint.py) when that directory exists; otherwise, and without
``checkpoint_dir``, weights are random, made on the device from a seed.
The generation default mirrors the JAX provider's 4096-token cap.

``GPUProvider(device=None)`` runs on the current CUDA card and raises when
there is none; ``device="cpu"`` runs the same path on the CPU. The
quantization modes (``quant``, ``kv_quant``, ``w8a8``, ``decode_w8a8``,
``int4_impl``) go to every engine the provider builds; unknown modes raise
in the constructor, before anything is built.

``prefix_cache`` and ``prefix_cache_max_mb`` go to every engine (prefix
snapshot reuse, on by default as in the JAX package); ``release()`` drops
the engines with their snapshots and open prefill sessions.

``batch_streams`` > 1 routes every request for a preset through one
``ContinuousBatcher`` over that preset's engine (built once, under a build
lock), so concurrent streams of one model share the decode; greedy results
equal the single-stream path's. ``pool_prefix`` and ``pool_prefix_min``
(shared-prefix serving: a panel of one model fans one prompt out to N
streams), ``prefill_budget`` (interleaved admission), ``pool_bucket``
(occupancy row-bucketing) and ``preempt`` (priority preemption) go to the
batcher, and each request's ``priority`` (None: NORMAL) to its submit. A
submit the batcher refuses (``RuntimeError`` or
``ValueError``: it is closed) or a submission a concurrent close cancelled
goes to the single-stream ``engine.generate``.

The retry ladder (the JAX provider's): a failed engine build gets one more
build; a failed generate on which nothing streamed yet evicts the engine,
drops the last reference to it, builds a fresh one and retries once (the
rebuild runs outside the ``except`` block, so the failed engine is
collectible before the new one allocates). On one card there is nowhere
else to place the model, so a second failure fails it (a warning in the
run, as the runner's best-effort rule says). ``torch.cuda.OutOfMemoryError``
is the transient the ladder is for. No step catches ``Cancelled``,
``DeadlineExceeded`` or a ``ValueError`` of the request, nor a
``KernelBuildError`` or ``KernelLaunchError``: a retry on the same kernel
would only hide the fault, so those propagate.

Telemetry (obs/), bound at construction: an ``engine_stream`` span per
request (recorder and flight recorder), the per-token latency into the live
plane labeled by the request's priority class and outcome, and the
run-aggregate decode counters (``decode_tokens``, ``decode_s``, the MFU
weights) the CLI's footer and ``metrics.json`` read.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from concurrent.futures import CancelledError
from typing import Optional

from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.engine.engine import PREFIX_CACHE_MAX_MB
from llm_consensus_tpu_torch.obs.live import class_label
from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError
from llm_consensus_tpu_torch.pressure.priority import PRIORITY_NORMAL
from llm_consensus_tpu_torch.providers.base import Provider, Request, Response, StreamCallback
from llm_consensus_tpu_torch.utils.context import Cancelled, Context, DeadlineExceeded
from llm_consensus_tpu_torch.utils.device import DeviceLike, device_name, resolve_device

DEFAULT_MAX_NEW_TOKENS = 4096
SCHEME = "gpu:"
# Errors the retry ladder never retries: a cancel or deadline, the
# request's own ValueError, and a kernel that failed to build or launch.
_NO_RETRY = (Cancelled, DeadlineExceeded, ValueError, KernelBuildError, KernelLaunchError)


def parse_model_name(model: str) -> str:
    """``gpu:<preset>`` → preset name; validates against the catalog."""
    from llm_consensus_tpu_torch.models.config import MODEL_PRESETS

    name = model[len(SCHEME):] if model.startswith(SCHEME) else model
    if name not in MODEL_PRESETS:
        available = [f"{SCHEME}{m}" for m in sorted(MODEL_PRESETS)]
        raise ValueError(f"unknown gpu model {model!r}; available: {available}")
    return name


def _resolve_modes(*, quant: Optional[str] = None, kv_quant: Optional[str] = None,
                   w8a8: bool = False, decode_w8a8: bool = False,
                   int4_impl: Optional[str] = None) -> dict:
    """The quantization modes as every engine takes them; an unknown mode
    raises ``ValueError`` here, before anything is built."""
    from llm_consensus_tpu_torch.ops.quant import (
        KV_MODES, WEIGHT_MODES, resolve_int4_impl, resolve_mode)

    return {
        "quant": resolve_mode(quant, "quant", WEIGHT_MODES),
        "kv_quant": resolve_mode(kv_quant, "kv_quant", KV_MODES),
        "w8a8": bool(w8a8), "decode_w8a8": bool(decode_w8a8),
        "int4_impl": resolve_int4_impl(int4_impl),
    }


class GPUProvider(Provider):
    """Serves every ``gpu:*`` model from a lazily built engine pool."""

    name = "gpu"
    _shared: dict = {}  # (device, modes, batching, checkpoints) → provider (see shared())
    _shared_lock = threading.Lock()

    def __init__(self, *, device: DeviceLike = None, max_seq: Optional[int] = None,
                 batch_streams: int = 1, pool_prefix: bool = True, pool_prefix_min: int = 192,
                 prefill_budget: int = 0, pool_bucket: bool = True, preempt: bool = True,
                 checkpoint_dir: Optional[str] = None, prefix_cache: bool = True,
                 prefix_cache_max_mb: float = PREFIX_CACHE_MAX_MB, **modes):
        self.modes = _resolve_modes(**modes)
        self.prefix = {"prefix_cache": bool(prefix_cache),
                       "prefix_cache_max_mb": float(prefix_cache_max_mb)}
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir or None
        self.batch_streams = batch_streams
        self.pool_prefix = pool_prefix
        self.pool_prefix_min = pool_prefix_min
        self.prefill_budget = prefill_budget
        self.pool_bucket = pool_bucket
        self.preempt = preempt
        self._engines: dict[str, object] = {}
        self._batchers: dict[str, object] = {}
        self._lock = threading.Lock()
        self._build_locks: dict[tuple[str, str], threading.Lock] = {}
        # Context-capacity cap: every engine's max_seq is at most this
        # (KV-cache memory is proportional to capacity).
        self._max_seq = max_seq
        self.stats = {"tokens": 0, "runs": 0}
        self._obs = obs.recorder()
        self._live = obs.live.metrics()
        self._bb = obs.blackbox.ring()

    @classmethod
    def shared(cls, device: DeviceLike = None, *, batch_streams: int = 1,
               pool_prefix: bool = True, pool_prefix_min: int = 192, prefill_budget: int = 0,
               pool_bucket: bool = True, preempt: bool = True,
               checkpoint_dir: Optional[str] = None, prefix_cache: bool = True,
               prefix_cache_max_mb: float = PREFIX_CACHE_MAX_MB, **modes) -> "GPUProvider":
        """One provider per device, quantization modes, batching settings,
        checkpoint directory and prefix settings for the process (the CLI's
        factory): a quantized run never reuses a bf16 engine, a batched run
        never an unbatched provider, a checkpointed run never random
        weights."""
        dev = resolve_device(device)
        modes = _resolve_modes(**modes)
        batching = {"batch_streams": batch_streams, "pool_prefix": bool(pool_prefix),
                    "pool_prefix_min": pool_prefix_min, "prefill_budget": max(0, prefill_budget),
                    "pool_bucket": bool(pool_bucket), "preempt": bool(preempt)}
        prefix = {"prefix_cache": bool(prefix_cache),
                  "prefix_cache_max_mb": float(prefix_cache_max_mb)}
        checkpoint_dir = checkpoint_dir or None
        key = (dev, tuple(sorted(modes.items())), tuple(sorted(batching.items())),
               checkpoint_dir, tuple(sorted(prefix.items())))
        with cls._shared_lock:
            if key not in cls._shared:
                cls._shared[key] = cls(device=dev, checkpoint_dir=checkpoint_dir, **batching,
                                       **prefix, **modes)
            return cls._shared[key]

    def prepare(self, models: list[str], judge: Optional[str]) -> None:
        """Build the CUDA kernels before the panel fan-out, so the first
        build never runs inside a model's deadline."""
        if self.device.type == "cuda":
            from llm_consensus_tpu_torch.ops.kernels.build import ensure_built

            ensure_built()

    def engines(self) -> dict:
        """Built engines by preset (a snapshot)."""
        with self._lock:
            return dict(self._engines)

    def batcher_stats(self) -> dict:
        """Phase-accounting snapshot of every live batcher, keyed by preset
        (``ContinuousBatcher.snapshot``)."""
        with self._lock:
            batchers = dict(self._batchers)
        return {preset: b.snapshot() for preset, b in batchers.items()}

    def release(self) -> None:
        """Close every batcher and drop every engine with its prefix
        snapshot and open prefill sessions (weights and caches become
        collectible, even where a caller still holds an engine or a
        session)."""
        with self._lock:
            batchers = list(self._batchers.values())
            engines = list(self._engines.values())
            self._batchers.clear()
            self._engines.clear()
        for b in batchers:
            b.close()
        for engine in engines:
            engine.drop_prefix()
            engine.close_sessions()

    def _evict(self, preset: str, engine) -> None:
        """Drop ``preset``'s engine and batcher when they are still
        ``engine``'s (a concurrent retry may have published a healthy
        replacement already), closing the batcher."""
        with self._lock:
            if self._engines.get(preset) is engine:
                del self._engines[preset]
            batcher = self._batchers.get(preset)
            if batcher is not None and batcher.engine is engine:
                del self._batchers[preset]
            else:
                batcher = None
        if batcher is not None:
            batcher.close()

    def _get_or_build(self, table: dict, kind: str, preset: str, build):
        """``table[preset]``, built by ``build(preset)`` on first use.
        Construction happens outside the pool lock under a per-(kind,
        preset) lock, so distinct presets build concurrently while duplicate
        first requests for one preset share a single build (one engine, one
        pool cache)."""
        with self._lock:
            obj = table.get(preset)
            if obj is not None:
                return obj
            build_lock = self._build_locks.setdefault((kind, preset), threading.Lock())
        with build_lock:
            with self._lock:
                obj = table.get(preset)
            if obj is None:
                obj = build(preset)
                with self._lock:
                    table[preset] = obj
            return obj

    def _engine_for(self, model: str):
        """Get or lazily build the engine serving ``model``."""
        return self._get_or_build(self._engines, "engine", parse_model_name(model),
                                  self._build_engine)

    def _build_engine(self, preset: str):
        from llm_consensus_tpu_torch.engine import Engine
        from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
        from llm_consensus_tpu_torch.engine.tokenizer import load_tokenizer
        from llm_consensus_tpu_torch.models.config import get_config

        cfg = get_config(preset)
        params = tokenizer = None
        if self.checkpoint_dir:
            ckpt = os.path.join(self.checkpoint_dir, preset)
            params = try_load_params(cfg, ckpt, device=self.device, quant=self.modes["quant"])
            tokenizer = load_tokenizer(ckpt)
        max_seq = min(self._max_seq, cfg.max_seq_len) if self._max_seq else None
        return Engine(cfg, params, device=self.device, max_seq=max_seq, tokenizer=tokenizer,
                      **self.modes, **self.prefix)

    def _batcher_for(self, preset: str, engine):
        """The batcher serving ``preset`` over ``engine``, built once."""
        from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

        return self._get_or_build(self._batchers, "batcher", preset, lambda _: ContinuousBatcher(
            engine, max_batch=self.batch_streams, pool_prefix=self.pool_prefix,
            pool_prefix_min=self.pool_prefix_min, prefill_budget=self.prefill_budget,
            pool_bucket=self.pool_bucket, preempt=self.preempt))

    def _generate(self, engine, preset: str, prompt: str, sampling, ctx: Context, cb,
                  priority: Optional[int] = None):
        """One generate of ``prompt`` on ``engine``, through the preset's
        batcher (at ``priority``, None for NORMAL) when batching; a refused
        or cancelled submission runs single-stream."""
        if self.batch_streams <= 1:
            return engine.generate(prompt, sampling, ctx, on_text=cb)
        batcher = self._batcher_for(preset, engine)
        try:
            fut = batcher.submit(prompt, sampling, ctx, on_text=cb,
                                 priority=PRIORITY_NORMAL if priority is None else priority)
        except (KernelBuildError, KernelLaunchError):
            raise
        except (RuntimeError, ValueError):
            # A closed batcher (a shutdown or eviction race): direct path.
            return engine.generate(prompt, sampling, ctx, on_text=cb)
        try:
            return fut.result()
        except CancelledError:
            # A concurrent close cancelled the queued submission: a benign
            # race, not an engine failure.
            return engine.generate(prompt, sampling, ctx, on_text=cb)

    def query(self, ctx: Context, req: Request) -> Response:
        return self.query_stream(ctx, req, None)

    def query_stream(
        self, ctx: Context, req: Request, callback: Optional[StreamCallback]
    ) -> Response:
        from llm_consensus_tpu_torch.engine import SamplingParams
        from llm_consensus_tpu_torch.utils.flops import decode_mbu, decode_mfu

        try:
            engine = self._engine_for(req.model)
        except _NO_RETRY:
            raise
        except Exception:  # noqa: BLE001 — a transient build failure: one more build
            ctx.raise_if_done()
            engine = self._engine_for(req.model)
        start = time.monotonic()
        t0_ns = time.monotonic_ns() if self._obs is not None or self._bb is not None else 0
        sampling = SamplingParams(
            max_new_tokens=(
                req.max_tokens if req.max_tokens is not None else DEFAULT_MAX_NEW_TOKENS
            ),
            temperature=req.temperature if req.temperature is not None else 0.0,
        )
        prompt = req.prompt
        if req.system:
            # The plain engine has no chat template; fold the system
            # prompt ahead of the user prompt.
            prompt = f"{req.system}\n\n{req.prompt}"
        streamed = [0]
        cb = callback
        if callback is not None:
            def cb(chunk, _callback=callback):
                streamed[0] += 1
                _callback(chunk)
        preset = parse_model_name(req.model)
        retry = False
        try:
            result = self._generate(engine, preset, prompt, sampling, ctx, cb, req.priority)
        except _NO_RETRY:
            raise
        except Exception:  # noqa: BLE001 — one rebuild, unless text already streamed
            if streamed[0]:
                raise
            retry = True
        if retry:
            # Outside the except block: the traceback no longer pins the
            # failed engine's frames, so it is collectible before the
            # fresh one allocates.
            ctx.raise_if_done()  # never pay a rebuild for a doomed request
            self._evict(preset, engine)
            engine = None
            gc.collect()
            engine = self._engine_for(req.model)
            result = self._generate(engine, preset, prompt, sampling, ctx, cb, req.priority)
        with self._lock:
            self.stats["tokens"] += len(result.token_ids)
            self.stats["runs"] += 1
        if result.finish_reason in ("deadline", "cancelled"):
            # A timed-out model is a failed model, not a partial success.
            ctx.raise_if_done()

        # Steady-state decode rate from the engine's fetch-boundary clock;
        # None when the run fit one chunk (too short to measure).
        tokens_per_sec = mfu = mbu = None
        if result.decode_s > 0 and result.decode_tokens > 0:
            tokens_per_sec = result.decode_tokens / result.decode_s
            kind = device_name(self.device)
            mid_context = result.prompt_tokens + len(result.token_ids) // 2
            mfu = decode_mfu(engine.cfg, tokens_per_sec, kind, context_len=mid_context)
            # Bytes per weight and per cache element of this engine's modes
            # (the JAX provider's widths).
            itemsize = engine.dtype.itemsize
            mbu = decode_mbu(
                engine.cfg, tokens_per_sec, kind, context_len=mid_context,
                weight_bytes={"int8": 1, "int4": 0.5}.get(engine.quant, itemsize),
                kv_bytes=1 if engine.kv_quant == "int8" else itemsize,
            )
        for rec in (self._obs, self._bb):
            if rec is not None:
                rec.complete("engine_stream", t0_ns, tid="engine", model=req.model,
                             tokens=len(result.token_ids))
        if self._live is not None and result.token_ids:
            # Steady-state decode cadence when the engine measured one, else
            # the whole request's mean per token.
            if result.decode_tokens and result.decode_s > 0:
                per_tok = result.decode_s / result.decode_tokens
            else:
                per_tok = (time.monotonic() - start) / len(result.token_ids)
            self._live.observe("token_latency", per_tok,
                               outcome="preempted" if getattr(result, "preempted", False) else "ok",
                               **{"class": class_label(PRIORITY_NORMAL if req.priority is None
                                                       else req.priority)})
        if self._obs is not None and tokens_per_sec is not None:
            # Run aggregates: the footer divides the sums; MFU re-weights by
            # the tokens that reported one.
            self._obs.count("decode_tokens", result.decode_tokens)
            self._obs.count("decode_s", result.decode_s)
            if mfu is not None:
                self._obs.count("mfu_weighted_tokens", mfu * result.decode_tokens)
                self._obs.count("mfu_tokens", result.decode_tokens)
        return Response(
            model=req.model,
            content=result.text,
            provider=self.name,
            latency_ms=(time.monotonic() - start) * 1000,
            truncated=result.truncated_prompt,
            tokens=len(result.token_ids),
            tokens_per_sec=tokens_per_sec,
            mfu=mfu,
            mbu=mbu,
        )
