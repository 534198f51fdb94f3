"""Continuous batching: admission and eviction of decode streams mid-flight
(port of ``llm_consensus_tpu/engine/batcher.py``, its classic path).

A fixed pool of ``max_batch`` slots decodes as one batch while new requests
are admitted into free slots between decode chunks and finished streams
are evicted without stopping their neighbours. Decode reads every weight
once per step whatever the batch, so co-resident streams share that cost.

  * **One shared frontier.** Every row writes the same cache slot each
    step; a row's prompt is spliced so that it ends exactly at the
    frontier, and ``row_start`` makes its positions row-relative, which is
    what the admission prefill wrote: no re-RoPE. A prompt longer than the
    frontier waits until it fits or the pool drains (an idle pool resets
    the frontier to fit its wave).
  * **Admission waves.** The streams admissible in one pass share one
    batched prefill (``Engine._prefill_rows``, padded to a power-of-two
    row count), spliced into their slots in place; a failed batched
    prefill falls back to one-by-one admission.
  * **Shared prefix (the one-prompt fan-out).** When an idle pool's wave
    shares a common prompt prefix of at least ``pool_prefix_min`` tokens,
    that prefix is prefilled once and kept as one dense [L, 1, P, Hkv, dh]
    KV; the wave's rows hold only their suffixes and every decode step
    merges attention over the one prefix copy with each row's own window
    exactly (the decode kernel's ``return_state``). Later waves whose every
    prompt starts with the prefix join it; other prompts admit with their
    whole prompt beside the prefix rows (``prefix_rows`` false).
  * **Compaction at the waterline.** When the frontier reaches capacity,
    every live window slides left by the common reclaimable amount, in
    place (one layer at a time through a bounded scratch copy), and the
    row starts follow.
  * **Fetch and emit on a worker thread**, behind a depth-2 dispatch
    pipeline: the scheduler enqueues chunk N+1 (and admissions) while the
    worker waits on chunk N's copy to the host. The scheduler thread
    launches all device work on one stream; the worker only reads each
    chunk's own freshly allocated token copy after its CUDA event.

Sampling shape (temperature/top_k/top_p) is per batcher; ``max_new_tokens``
and ``ignore_eos`` are per stream. A stream's seed draws its first token
(as the single-stream engine's seeded generator would); decode steps draw
from the batcher's own generator. Greedy streams produce exactly the
single-stream engine's tokens.

Telemetry (obs/), bound at construction as the JAX batcher binds it: the
recorder gets ``admit``, ``establish``, ``compact``, ``drain``, ``decode``
and ``fetch`` spans (tid "batcher"), the flight recorder the decode and
fetch spans and a dump at a fatal loop exit, and the attribution ledger
the stream interval of every dispatch (an admission wave or a
shared-prefix establishment as ``prefill``, a compaction as ``compact``, a
decode chunk as ``decode``: :class:`DeviceWall`, read by the fetch worker
after the next chunk's copy), the ``useful`` tokens, the pool cache's
bytes and the host gaps between a drained pipeline and the next dispatch,
by scheduler phase.

Not ported (each listed in ROADMAP.md): speculative rounds, preemption and
brownout, interleaved admission (``prefill_budget`` > 0, refused),
occupancy row-bucketing (``max_batch`` above 8, refused), the journal, the
integrity sentinel, weight-swap pins and ``abandon``/heartbeat. Settings
are constructor arguments with the JAX knobs' defaults; nothing here reads
the environment.
"""

from __future__ import annotations

import atexit
import threading
import time
import warnings
from contextlib import contextmanager
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from queue import SimpleQueue
from typing import Callable, Iterable, Optional

import torch

from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.engine.engine import (
    DeviceWall, Engine, GenerateResult, SamplingParams, _bucket, _Fetch)
from llm_consensus_tpu_torch.engine.tokenizer import StreamDecoder
from llm_consensus_tpu_torch.models.transformer import init_kv_cache
from llm_consensus_tpu_torch.ops.quant import is_quantized, kv_capacity, kv_seq_axis
from llm_consensus_tpu_torch.ops.sampling import sample_token
from llm_consensus_tpu_torch.utils.context import Context

# The JAX batcher row-buckets a pool of more than max(8, max_batch // 8)
# rows, i.e. any pool above 8; the port serves only pools of at most 8.
MIN_BUCKET_ROWS = 8


@dataclass
class _Stream:
    """Host-side state of one admitted or queued stream."""
    future: Future
    sampling: SamplingParams
    ctx: Context
    on_text: Optional[Callable[[str], None]]
    prompt_tokens: int
    decoder: StreamDecoder
    submitted: float
    truncated: bool
    max_new: int
    out_ids: list = field(default_factory=list)
    parts: list = field(default_factory=list)
    finish: str = "length"
    # Tokens covered by dispatched work: 1 (the prefill-sampled first
    # token) plus n_steps per chunk dispatched while live. planned >=
    # max_new means more dispatch is dead stepping.
    planned: int = 1


# -- cache helpers (in place) ---------------------------------------------------


def _leaves(*sides) -> Iterable[tuple]:
    """Matching leaves of cache sides (a bf16 stack, or an int8 dict's
    codes and scales)."""
    if is_quantized(sides[0]):
        yield tuple(side["q8"] for side in sides)
        yield tuple(side["s"] for side in sides)
    else:
        yield tuple(sides)


def splice_rows(batch_cache: dict, src_cache: dict, src_rows, slots, dsts,
                width: int) -> None:
    """Copy slots [0, width) of rows ``src_rows`` of an admission cache into
    ``batch_cache`` rows ``slots`` at offsets ``dsts``, in place. Junk past
    a prompt inside the width lands at slots at or past the frontier,
    which decode overwrites before reading. Raises when a destination runs
    past capacity (a slice assignment would truncate silently)."""
    cap = kv_capacity(batch_cache["k"])
    for dst in dsts:
        if dst < 0 or dst + width > cap:
            raise ValueError(f"splice of width {width} at slot {dst} overruns capacity {cap}")
    for side in ("k", "v"):
        for bdst, src in _leaves(batch_cache[side], src_cache[side]):
            ax = kv_seq_axis(src) - 1  # the seq axis once a row is indexed
            for r, slot, dst in zip(src_rows, slots, dsts):
                bdst[:, slot].narrow(ax, dst, width).copy_(src[:, r].narrow(ax, 0, width))


def extract_prefix(pcache: dict, p_cap: int) -> dict:
    """Slots [0, p_cap) of a [1, S] prefill cache as the pool's shared-prefix
    KV [L, 1, p_cap, Hkv, dh], dense in the compute dtype: an int8 cache is
    dequantized here, once (the prefix is one read-only row)."""
    def entry(e):
        if is_quantized(e):
            sc = e["s"][..., :p_cap]
            return e["q8"][:, :, :p_cap].to(sc.dtype) * sc.transpose(2, 3)[..., None]
        return e[:, :, :p_cap].clone()

    return {"k": entry(pcache["k"]), "v": entry(pcache["v"])}


def compact_cache(cache: dict, shift: int) -> None:
    """Slide every row's window left by ``shift`` slots, in place, one layer
    at a time (the scratch is one layer's source window, not a second
    cache). Slots past the new frontier keep stale data, which the valid
    mask excludes and decode overwrites."""
    for side in ("k", "v"):
        for (leaf,) in _leaves(cache[side]):
            ax = kv_seq_axis(leaf) - 1  # seq axis of one layer
            n = leaf.shape[ax + 1] - shift
            for layer in leaf:
                layer.narrow(ax, 0, n).copy_(layer.narrow(ax, shift, n).clone())


class ContinuousBatcher:
    """Continuous-batching scheduler over one Engine.

    ``submit()`` returns a ``Future[GenerateResult]``; a scheduler thread
    owns the batch cache and runs the admit → dispatch loop, a fetch
    thread the fetch → emit → retire half. ``close()`` cancels queued
    submissions, lets in-flight streams finish, and stops both threads.

    ``prefill_budget`` > 0 (interleaved admission) and a ``max_batch`` that
    the JAX batcher would row-bucket (above 8) raise ``NotImplementedError``.
    ``pool_prefix`` and ``pool_prefix_min`` are the shared-prefix switch
    and threshold (``LLMC_POOL_PREFIX``, ``LLMC_POOL_PREFIX_MIN``).
    """

    def __init__(self, engine: Engine, max_batch: int = 8, *, prefill_budget: int = 0,
                 pool_prefix: bool = True, pool_prefix_min: int = 192):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if prefill_budget > 0:
            raise NotImplementedError(
                "interleaved admission (prefill_budget > 0) is not ported; use 0")
        if max_batch > MIN_BUCKET_ROWS:
            raise NotImplementedError(
                f"max_batch {max_batch}: occupancy row-bucketing is not ported "
                f"(at most {MIN_BUCKET_ROWS} rows)")
        self.engine = engine
        self.max_batch = max_batch
        # Cross-thread state (the queue, the pipeline depth, the stats) is
        # guarded by _work; scheduler-owned state (_slots writes of a
        # stream, the cache, the prefix fields) has one writer, the
        # scheduler thread. The fetch worker only writes slots
        # stream → None (retirement), the scheduler only None → stream.
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: list[tuple[list, _Stream]] = []
        self._slots: list[Optional[_Stream]] = [None] * max_batch
        self._closed = False
        self._template: Optional[tuple] = None  # (temperature, top_k, top_p)
        dev = engine.device
        with torch.inference_mode():
            self._token = torch.zeros(max_batch, dtype=torch.long, device=dev)
            self._row_start = torch.zeros(max_batch, dtype=torch.int32, device=dev)
            self._prefix_rows = torch.zeros(max_batch, dtype=torch.bool, device=dev)
            self._cache = init_kv_cache(
                engine.cfg, batch=max_batch, max_seq=engine.max_seq, device=dev,
                dtype=engine.dtype, quant=engine.kv_quant,
            )
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self._row_start_host = [0] * max_batch
        self._pos = 0  # shared frontier (host int)
        # Shared-prefix pool state. Gated off for sliding-window models
        # (the window would span the prefix/suffix seam).
        self._prefix_enabled = bool(pool_prefix) and engine.cfg.sliding_window is None
        self._prefix_min = pool_prefix_min
        self._prefix_ids: Optional[tuple] = None
        self._prefix_cache: Optional[dict] = None
        self._prefix_len_host = 0
        # decode_s counts arrival-to-arrival intervals (dispatch-to-arrival
        # after a drained pipeline) of chunks that ran alone on the device
        # (no admission or compaction since the last dispatch) and emitted
        # tokens; admit_s/establish_s the scheduler's
        # admission-prefill and prefix-establishment walls (admit_tokens the
        # prompt tokens admission prefilled, admitted the streams it
        # installed; establish_tokens the prefix tokens established);
        # absorb_s the bounded burst-absorption pauses. Guarded by _work.
        self.stats = {
            "decode_tokens": 0, "decode_s": 0.0, "admit_s": 0.0, "admit_tokens": 0,
            "admitted": 0, "establish_s": 0.0, "establish_tokens": 0, "absorb_s": 0.0,
        }
        self._prev_arrival: Optional[float] = None
        self._unfetched = 0  # dispatched chunks not yet emitted (guarded by _work)
        self._nondecode_work = False  # admission/compaction since last dispatch
        self._worker_exc: Optional[BaseException] = None  # guarded by _work
        # Telemetry planes, bound once: a plane off costs one None check
        # per chunk on the scheduler and fetch loops.
        self._obs = obs.recorder()
        self._bb = obs.blackbox.ring()
        self._attrib = obs.attrib.ledger()
        if self._attrib is not None:
            self._attrib.update_component(f"pool_cache:{engine.cfg.name}", sum(
                t.numel() * t.element_size()
                for side in self._cache.values() for (t,) in _leaves(side)))
        # Device intervals of the admissions and compactions since the last
        # dispatch (scheduler-owned): they ride the next chunk to its fetch.
        self._walls: list[tuple[str, DeviceWall]] = []
        # Host-gap state: _idle_at marks the arrival that drained the
        # pipeline while work remained; _gap_phase names the scheduler
        # phase that ran in the gap.
        self._idle_at: Optional[float] = None
        self._gap_phase = "schedule"
        # A chunk is being enqueued (its steps already run on the device,
        # but it joins _unfetched only once whole): no gap while it is.
        self._dispatching = False  # guarded by _work
        self._fetch_q: SimpleQueue = SimpleQueue()
        self._fetch_thread = threading.Thread(
            target=self._fetch_worker, name="llmc-batcher-fetch", daemon=True)
        self._fetch_thread.start()
        self._thread = threading.Thread(target=self._run, name="llmc-batcher", daemon=True)
        self._thread.start()
        # A daemon scheduler still launching work while the interpreter
        # tears down aborts the process; close cleanly at exit.
        atexit.register(self.close)

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: str, sampling: SamplingParams = SamplingParams(),
               ctx: Optional[Context] = None,
               on_text: Optional[Callable[[str], None]] = None) -> "Future[GenerateResult]":
        """Queue a prompt; the Future resolves to the single-stream API's
        GenerateResult shape."""
        eng = self.engine
        prompt_ids, truncated = eng._budget_prompt(
            eng.tokenizer.encode(prompt), sampling.max_new_tokens)
        return self.submit_ids(prompt_ids, sampling, ctx=ctx, on_text=on_text,
                               truncated=truncated)

    def submit_ids(self, prompt_ids: list, sampling: SamplingParams = SamplingParams(),
                   ctx: Optional[Context] = None,
                   on_text: Optional[Callable[[str], None]] = None, *,
                   truncated: bool = False) -> "Future[GenerateResult]":
        """Token-level submit (``prompt_ids`` already budgeted)."""
        eng = self.engine
        if not prompt_ids:
            raise ValueError("empty prompt")
        shape = (sampling.temperature, sampling.top_k, sampling.top_p)
        stream = _Stream(
            future=Future(), sampling=sampling, ctx=ctx or Context.background(),
            on_text=on_text, prompt_tokens=len(prompt_ids),
            decoder=StreamDecoder(eng.tokenizer), submitted=time.monotonic(),
            truncated=truncated,
            max_new=min(sampling.max_new_tokens, eng.max_seq - len(prompt_ids)),
        )
        with self._work:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._template is None:
                self._template = shape
            elif shape != self._template:
                raise ValueError(
                    f"sampling shape {shape} does not match this batcher's "
                    f"{self._template} (temperature/top_k/top_p are per-batcher; "
                    "max_new_tokens/ignore_eos are per-stream)")
            self._queue.append((list(prompt_ids), stream))
            self._work.notify()
        return stream.future

    def close(self) -> None:
        atexit.unregister(self.close)
        with self._work:
            self._closed = True
            for _, s in self._queue:
                s.future.cancel()
            self._queue.clear()
            self._work.notify()
        self._thread.join(timeout=120)
        if self._thread.is_alive():
            warnings.warn(
                "ContinuousBatcher scheduler still running 120s after close(); its KV "
                "cache remains allocated until in-flight streams finish",
                RuntimeWarning, stacklevel=2)

    def snapshot(self) -> dict:
        """A consistent copy of the phase-accounting stats, plus the
        established shared-prefix length (0 when none)."""
        with self._work:
            snap = dict(self.stats)
        snap["prefix_len"] = self._prefix_len_host
        return snap

    # -- admission -------------------------------------------------------------

    def _sample_firsts(self, last_logits: torch.Tensor, streams: list) -> torch.Tensor:
        """Each admitted row's first token [k] from its prefill logits: one
        argmax for a greedy pool, else per row from the stream's seed (the
        single-stream engine's first draw)."""
        sp = streams[0].sampling
        if sp.temperature == 0.0:
            return torch.argmax(last_logits, dim=-1)
        dev = last_logits.device
        return torch.cat([
            sample_token(last_logits[i:i + 1],
                         torch.Generator(device=dev).manual_seed(s.sampling.seed),
                         sp.temperature, sp.top_k, sp.top_p)
            for i, s in enumerate(streams)
        ])

    def _set_rows(self, slots: list, tokens: torch.Tensor, dsts: list, prefix: bool) -> None:
        """Install admitted rows' device state: first token, row start and
        prefix participation (in place, in stream order behind any chunk
        already enqueued)."""
        eng = self.engine
        slot_t = eng.to_device(slots)
        self._token[slot_t] = tokens
        self._row_start[slot_t] = eng.to_device(dsts, torch.int32)
        self._prefix_rows[slot_t] = prefix

    def _admit(self, slot: int, prompt_ids: list, s: _Stream) -> tuple:
        """Prefill one stream alone and splice it so the prompt ends at the
        shared frontier; a lone admission carries its whole prompt, so it
        never attends the pool prefix. Returns the firsts entry."""
        eng = self.engine
        last_logits, pcache = eng._prefill_ids(prompt_ids)
        return self._install_wave([(slot, prompt_ids, s)], 0, last_logits, pcache,
                                  _bucket(len(prompt_ids), eng.max_seq))

    def _establish_prefix(self, prefix_ids: list[int]) -> bool:
        """Prefill the wave's common prefix once and install it as the
        pool's shared-prefix KV (pool idle). Returns False, state cleared,
        when it does not fit or fails."""
        eng = self.engine
        p = len(prefix_ids)
        # 128-slot granule: prefix-attention work scales with p_cap.
        p_cap = min(-(-p // 128) * 128, eng.max_seq)
        cfg = eng.cfg
        dense_bytes = 2 * cfg.n_layers * p_cap * cfg.n_kv_heads * cfg.head_dim * eng.dtype.itemsize
        if p_cap < p or dense_bytes > eng.prefix_max_bytes:
            # Clearing any prior prefix is safe (the pool is idle) and
            # needed: keeping it would hold the memory this cap bounds.
            self._clear_prefix()
            return False
        try:
            _, pcache = eng._prefill_ids(prefix_ids)
            self._prefix_cache = extract_prefix(pcache, p_cap)
        except Exception:  # noqa: BLE001 — establishment is an optimization
            self._clear_prefix()
            # Otherwise every later idle wave repeats the failing prefill.
            warnings.warn("shared-prefix establishment prefill failed; disabling pool "
                          "prefix sharing for this batcher", RuntimeWarning, stacklevel=2)
            self._prefix_enabled = False
            return False
        self._prefix_ids = tuple(prefix_ids)
        self._prefix_len_host = p
        return True

    def _clear_prefix(self) -> None:
        self._prefix_cache = None
        self._prefix_ids = None
        self._prefix_len_host = 0

    def _wave_k_pad(self, k: int) -> int:
        """The wave's rows padded to a power of two, floored at
        max_batch / 4 and 8 and capped at max_batch (the JAX batcher's
        compile-variant bound; padding rows repeat row 0)."""
        k_pad = 1 << (k - 1).bit_length()
        return min(max(k_pad, self.max_batch // 4, 8), self.max_batch)

    def _admit_batch(self, batch: list, prefix_p: int = 0) -> Optional[list]:
        """Admit several streams with one batched prefill. ``prefix_p`` > 0:
        every row starts with the pool's ``prefix_p``-token shared prefix,
        so only the suffixes prefill and only suffix KV lands in the pool.
        Returns the firsts entries, or None when the batched prefill
        failed (the caller admits one by one)."""
        eng = self.engine
        rows = [ids for _, ids, _ in batch]
        pad_rows = rows + [rows[0]] * (self._wave_k_pad(len(rows)) - len(rows))
        try:
            if prefix_p:
                last_logits, pcache, width = eng._prefill_rows_suffix(
                    [r[prefix_p:] for r in pad_rows], self._prefix_cache, prefix_p)
            else:
                last_logits, pcache, width = eng._prefill_rows(pad_rows)
        except Exception:  # noqa: BLE001
            # Nothing changed yet: one-by-one admission makes a failure
            # cost one stream, not the wave. Failures past this point
            # (splice, install) are pool-fatal.
            return None
        return [self._install_wave(batch, prefix_p, last_logits, pcache, width)]

    def _install_wave(self, batch: list, prefix_p: int, last_logits: torch.Tensor,
                      pcache: dict, width: int) -> tuple:
        """Splice a wave's prefill cache into the pool at the current
        frontier and install its streams. Returns the firsts entry
        ``(slots, first-token fetch, owners)``."""
        k = len(batch)
        slots = [slot for slot, _, _ in batch]
        dsts = [self._pos - (len(ids) - prefix_p) for _, ids, _ in batch]
        splice_rows(self._cache, pcache, range(k), slots, dsts, width)
        samples = self._sample_firsts(last_logits[:k], [s for _, _, s in batch])
        self._set_rows(slots, samples, dsts, bool(prefix_p))
        owners = []
        for i, (slot, _ids, s) in enumerate(batch):
            self._row_start_host[slot] = dsts[i]
            self._slots[slot] = s
            owners.append(s)
        return (slots, _Fetch(samples), owners)

    # -- streams ---------------------------------------------------------------

    def _result(self, s: _Stream) -> GenerateResult:
        if s.on_text is None:
            # No streaming consumer: decode the raw tokens once.
            text = self.engine.tokenizer.decode(s.out_ids)
        else:
            tail = s.decoder.flush()
            if tail:
                s.parts.append(tail)
                s.on_text(tail)
            text = "".join(s.parts)
        return GenerateResult(
            token_ids=s.out_ids, text=text, finish_reason=s.finish,
            prompt_tokens=s.prompt_tokens,
            latency_ms=(time.monotonic() - s.submitted) * 1000,
            truncated_prompt=s.truncated,
        )

    def _retire(self, slot: int, finish: str) -> None:
        s = self._slots[slot]
        if s is None:
            return
        s.finish = finish
        self._slots[slot] = None
        # First writer wins: the scheduler's failure path may have failed
        # this future already.
        if not s.future.done():
            try:
                s.future.set_result(self._result(s))
            except InvalidStateError:
                pass

    def _emit(self, slot: int, tok: int, eos: int) -> bool:
        """Hand one token to its stream; True when it was appended."""
        s = self._slots[slot]
        if s is None:
            return False
        if tok == eos and not s.sampling.ignore_eos:
            self._retire(slot, "eos")
            return False
        s.out_ids.append(tok)
        if s.on_text is not None:
            text = s.decoder.push(tok)
            if text:
                s.parts.append(text)
                s.on_text(text)
        if len(s.out_ids) >= s.max_new:
            self._retire(slot, "length")
        return True

    def _stat_add_locked(self, **deltas) -> None:
        """Under ``_work``: accumulate stats."""
        for k, v in deltas.items():
            self.stats[k] += v

    def _stat_add(self, **deltas) -> None:
        with self._work:
            self._stat_add_locked(**deltas)

    # -- frontier --------------------------------------------------------------

    def _compact(self) -> None:
        """Give live rows fresh runway when the frontier hits capacity:
        retire rows that already fill the cache, slide every window left by
        the common reclaimable amount, re-align the row starts and pull
        the frontier back. Windows keep their offsets: no re-RoPE."""
        eng = self.engine
        for i, s in enumerate(self._slots):
            if s is not None and self._pos - self._row_start_host[i] >= eng.max_seq:
                self._retire(i, "length")
        vlens = [self._pos - self._row_start_host[i]
                 for i, s in enumerate(self._slots) if s is not None]
        if not vlens:
            return
        shift = self._pos - max(vlens)
        if shift <= 0:
            return
        compact_cache(self._cache, shift)
        self._row_start_host = [r - shift for r in self._row_start_host]
        self._row_start = self._row_start - shift
        self._pos -= shift

    def _plan_steps(self, chunk: int) -> int:
        """Steps of the next chunk: 1-step chunks inside the cache's last
        chunk of slots (no stream loses a token it could decode), the final
        chunk clamped to what a live stream still needs (power of two), and
        a 32-step opener after an idle period with the pool under half
        full, so a burst's stragglers admit sooner."""
        eng = self.engine
        n_steps = chunk if self._pos + chunk <= eng.max_seq else 1
        need = max((s.max_new - s.planned for s in self._slots if s is not None), default=0)
        if 0 < need < n_steps:
            n_steps = min(1 << max(need - 1, 0).bit_length(), n_steps)
        if (
            n_steps == chunk
            and self._unfetched == 0  # racy read: a heuristic only
            and chunk > 32
            and sum(1 for s in self._slots if s is not None) * 2 < self.max_batch
        ):
            n_steps = 32
        return n_steps

    # -- threads ---------------------------------------------------------------

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._loop()
        except BaseException as exc:  # noqa: BLE001 — fail every future
            if self._bb is not None:
                # The ring holds the spans leading up to the death.
                self._bb.instant("engine_crash", tid="batcher", error=repr(exc))
                self._bb.dump("engine_crash", extra={"error": repr(exc)})
            # Stop the fetch worker first: what it emits from queued chunks
            # is legitimate; only what remains gets the exception.
            self._fetch_q.put(None)
            self._fetch_thread.join(timeout=120)
            with self._work:
                self._closed = True
                queued = list(self._queue)
                self._queue.clear()
            for _, s in queued:
                if not s.future.cancel():
                    s.future.set_exception(exc)
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._slots[i] = None
                    if not s.future.done():
                        try:
                            s.future.set_exception(exc)
                        except InvalidStateError:
                            pass
            raise
        else:
            self._fetch_q.put(None)
            self._fetch_thread.join(timeout=120)

    def _fetch(self, fetch: _Fetch, owners: list, firsts: list, eos: int) -> tuple[int, float]:
        """Wait for one chunk's tokens (and the first tokens of waves
        admitted before it), emit them; returns ``(tokens emitted, arrival
        time)``, the time taken before the emit loop."""
        first_vals = [f.values() for _, f, _ in firsts]
        cols = list(zip(*fetch.values()))  # [n_steps][B] → [B][n_steps]
        t_arrival = time.monotonic()
        emitted = appended = 0
        for (slots, _, wave_owners), vals in zip(firsts, first_vals):
            for slot, owner, val in zip(slots, wave_owners, vals):
                if self._slots[slot] is owner:
                    appended += self._emit(slot, val, eos)
                    emitted += 1
        overshoot = 0
        for i, owner in enumerate(owners):
            if owner is None:
                continue
            taken = 0
            for tok in cols[i]:
                # Owner identity: a slot retired (and maybe reused)
                # mid-chunk never leaks its predecessor's tokens.
                if self._slots[i] is not owner:
                    break
                appended += self._emit(i, tok, eos)
                taken += 1
            emitted += taken
            # Dead stepping: steps this row computed that no stream took.
            overshoot += len(cols[i]) - taken
        if self._attrib is not None:
            self._attrib.token_event("useful", appended)
            self._attrib.token_event("overshoot", overshoot)
        return emitted, t_arrival

    def _fetch_worker(self) -> None:
        """Fetch side of the dispatch pipeline: waits on each chunk's copy,
        emits, retires finished and cancelled streams, and keeps the
        decode-phase clock."""
        eos = self.engine.tokenizer.eos_id
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            fetch, owners, firsts, pure, t_dispatch, walls = item
            if self._worker_exc is not None:
                # A prior fetch failed: emitting later chunks would resolve
                # streams with tokens missing. Drain; the scheduler fails
                # every live stream.
                with self._work:
                    self._unfetched -= 1
                    self._work.notify_all()
                continue
            t0_obs = (time.monotonic_ns()
                      if self._obs is not None or self._bb is not None else 0)
            try:
                emitted, t_arrival = self._fetch(fetch, owners, firsts, eos)
            except BaseException as exc:  # noqa: BLE001
                with self._work:
                    self._worker_exc = exc
                    self._unfetched -= 1
                    self._prev_arrival = None
                    self._work.notify_all()
                continue
            for rec in (self._obs, self._bb):
                if rec is not None:
                    rec.complete("fetch", t0_obs, tid="batcher", tokens=emitted, pure=pure)
            if self._attrib is not None:
                # This chunk's copy is done, so its interval and those of
                # the work enqueued before it read without a wait.
                for family, wall in walls:
                    self._attrib.observe_device(family, wall.seconds())
            # Cancellation after the emit, so a cancel never discards
            # tokens already decoded.
            for i, s in enumerate(self._slots):
                if s is not None and s.ctx.done():
                    self._retire(i, "deadline" if s.ctx.remaining() == 0.0 else "cancelled")
            with self._work:
                if pure and emitted:
                    ref = self._prev_arrival if self._prev_arrival is not None else t_dispatch
                    self._stat_add_locked(decode_tokens=emitted, decode_s=t_arrival - ref)
                self._prev_arrival = t_arrival
                self._unfetched -= 1
                if self._unfetched == 0:
                    # Drained: the next interval spans device idle time.
                    self._prev_arrival = None
                    if (self._attrib is not None and not self._dispatching
                            and (self._live() or self._queue)):
                        # Device idle begins on a batcher that still has
                        # work: the next dispatch closes the gap.
                        self._idle_at = t_arrival
                        self._gap_phase = "schedule"
                self._work.notify_all()

    def _drain_fetches(self) -> None:
        """Wait until every dispatched chunk is emitted (the barrier before
        compaction's full-row retires)."""
        t0_obs = self._obs.now() if self._obs is not None else 0
        with self._work:
            while self._unfetched > 0 and self._worker_exc is None:
                self._work.wait(0.1)
            if self._worker_exc is not None:
                raise self._worker_exc
        if self._obs is not None:
            self._obs.complete("drain", t0_obs, tid="batcher")

    # -- telemetry -------------------------------------------------------------

    @contextmanager
    def _wall(self, family: str):
        """Record the stream interval of the device work in the body as one
        ``family`` dispatch, booked at the next chunk's fetch."""
        if self._attrib is None:
            yield
            return
        wall = DeviceWall(self.engine.device)
        try:
            yield
        finally:
            self._walls.append((family, wall.stop()))

    def _admission_starts(self) -> float:
        """An admission begins now: a drained pipeline's gap ends here."""
        t = time.monotonic()
        if self._attrib is not None:
            with self._work:
                drained = self._unfetched == 0
            if drained:
                self._close_gap(t)
            self._gap_phase = "admit"
        return t

    def _close_gap(self, now: Optional[float] = None) -> None:
        """Book the armed device-idle gap, if any, up to ``now`` against the
        phase that ran in it."""
        if self._attrib is None:
            return
        with self._work:
            idle_at, self._idle_at = self._idle_at, None
        if idle_at is None:
            return
        phase, self._gap_phase = self._gap_phase, "schedule"
        self._attrib.gap((now if now is not None else time.monotonic()) - idle_at, phase)

    def _live(self) -> bool:
        return any(s is not None for s in self._slots)

    def _absorb(self, deadline_s: float, quiet_windows: int) -> None:
        """Under ``_work``: wait in 10 ms windows while submissions still
        arrive, until ``quiet_windows`` windows pass with no growth or
        ``deadline_s`` elapses (a burst's submits trickle in from many
        client threads; admitting its first arrival alone would split the
        wave and lose sharing)."""
        t_abs = time.monotonic()
        deadline = t_abs + deadline_s
        seen, quiet = -1, 0
        while not self._closed and quiet < quiet_windows and time.monotonic() < deadline:
            n = len(self._queue)
            quiet = quiet + 1 if n == seen else 0
            seen = n
            self._work.wait(timeout=0.01)
        self._stat_add_locked(absorb_s=time.monotonic() - t_abs)
        self._gap_phase = "absorb"

    def _plan_prefix(self, candidates: list, pool_idle: bool) -> int:
        """The wave's shared-prefix length (all or nothing): join the
        established prefix when every candidate extends it; on an idle
        pool, establish the wave's own common prefix when at least two
        candidates share ``pool_prefix_min`` tokens; else 0 (and an idle
        pool drops the prefix, back to the plain decode)."""
        p0 = self._prefix_len_host
        if self._prefix_cache is not None and all(
            len(r) > p0 and tuple(r[:p0]) == self._prefix_ids for r in candidates
        ):
            return p0
        if not pool_idle:
            return 0
        common = candidates[0]
        for r in candidates[1:]:
            m = min(len(common), len(r))
            i = 0
            while i < m and common[i] == r[i]:
                i += 1
            common = common[:i]
        # Every row keeps at least one suffix token.
        p = min(len(common), min(len(r) for r in candidates) - 1)
        if p < self._prefix_min or len(candidates) < 2:
            self._clear_prefix()
            return 0
        t_est = time.monotonic()
        self._close_gap(t_est)  # the pool is idle: nothing is in flight
        self._gap_phase = "establish"
        t0_obs = self._obs.now() if self._obs is not None else 0
        with self._wall("prefill"), obs.attrib.tag("prefill"):
            ok = self._establish_prefix(list(candidates[0][:p]))
        self._stat_add(establish_s=time.monotonic() - t_est, establish_tokens=p if ok else 0)
        if self._obs is not None:
            self._obs.complete("establish", t0_obs, tid="batcher", prefix=p, ok=ok)
        return p if ok else 0

    def _admission_pass(self, pending: list, firsts: list) -> list:
        """Admit what fits from ``pending``, in waves, until nothing more
        can be admitted; returns the requeue list (FIFO order kept)."""
        eng = self.engine
        requeue: list = []
        while True:
            free = [i for i in range(self.max_batch) if self._slots[i] is None]
            batch: list = []
            pool_idle = not self._live()
            candidates = [ids for ids, s in pending if not s.ctx.done() and s.max_new > 0]
            if pool_idle and not self._prefix_enabled and self._prefix_cache is not None:
                self._clear_prefix()  # sharing went off: back to the plain decode
            wave_p = 0
            if self._prefix_enabled and candidates and not requeue:
                wave_p = self._plan_prefix(candidates, pool_idle)
            if pool_idle and candidates and not requeue:
                # An idle frontier resets to the wave's longest window so
                # the whole wave right-aligns to it.
                self._pos = max(len(ids) - wave_p for ids in candidates[:self.max_batch])
            for ids, stream in pending:
                if stream.ctx.done():
                    stream.finish = "deadline" if stream.ctx.remaining() == 0.0 else "cancelled"
                    stream.future.set_result(self._result(stream))
                    continue
                if stream.max_new <= 0:
                    stream.future.set_result(self._result(stream))
                    continue
                if requeue or not free:
                    requeue.append((ids, stream))  # no leapfrogging
                    continue
                n = len(ids) - wave_p  # the window this row will occupy
                w_req = (_bucket(n, eng.max_seq) if wave_p
                         else max(_bucket(n, eng.max_seq), eng._rows_bucket(n)))
                if n > self._pos or (self._pos - n) + w_req > eng.max_seq:
                    requeue.append((ids, stream))
                    continue
                if batch:
                    # The wave splices at one width: every member must fit it.
                    members = [len(i2) - wave_p for _, i2, _ in batch] + [n]
                    w_new = (_bucket(max(members), eng.max_seq) if wave_p
                             else eng._rows_bucket(max(members)))
                    if any((self._pos - nj) + w_new > eng.max_seq for nj in members):
                        requeue.append((ids, stream))
                        continue
                batch.append((free.pop(0), ids, stream))
            pending = []
            singles: list = []
            if batch:
                self._nondecode_work = True
                t_adm = self._admission_starts()
                t0_obs = self._obs.now() if self._obs is not None else 0
                admitted = None
                try:
                    with self._wall("prefill"), obs.attrib.tag("prefill"):
                        admitted = self._admit_batch(batch, wave_p)
                finally:
                    ok = admitted is not None
                    self._stat_add(
                        admit_s=time.monotonic() - t_adm, admitted=len(batch) if ok else 0,
                        admit_tokens=sum(len(i2) - wave_p for _, i2, _ in batch) if ok else 0)
                    if self._obs is not None:
                        self._obs.complete("admit", t0_obs, tid="batcher", streams=len(batch),
                                           prefix=wave_p, ok=ok)
                if admitted is None:
                    singles = batch
                    if wave_p:
                        # The full-prompt singles cannot fit a suffix-sized
                        # frontier, so a failed suffix wave would retry
                        # forever: fall back to full-prompt admission.
                        warnings.warn("shared-prefix wave prefill failed; disabling pool "
                                      "prefix sharing for this batcher",
                                      RuntimeWarning, stacklevel=2)
                        self._prefix_enabled = False
                else:
                    firsts += admitted
            for slot, ids, stream in singles:
                n = len(ids)
                if n > self._pos or (self._pos - n) + _bucket(n, eng.max_seq) > eng.max_seq:
                    requeue.append((ids, stream))
                    continue
                self._nondecode_work = True
                t_adm = self._admission_starts()
                t0_obs = self._obs.now() if self._obs is not None else 0
                entry = None
                try:
                    with self._wall("prefill"), obs.attrib.tag("prefill"):
                        entry = self._admit(slot, ids, stream)
                except Exception as exc:  # noqa: BLE001 — fails this stream only
                    stream.future.set_exception(exc)
                finally:
                    ok = entry is not None
                    self._stat_add(admit_s=time.monotonic() - t_adm, admitted=int(ok),
                                   admit_tokens=len(ids) if ok else 0)
                    if self._obs is not None:
                        self._obs.complete("admit", t0_obs, tid="batcher", streams=1,
                                           prefix=0, ok=ok)
                if entry is not None:
                    firsts.append(entry)
            if requeue or not batch or all(st is not None for st in self._slots):
                return requeue
            with self._work:
                if self._closed:
                    return requeue
                if self._unfetched == 0:
                    # Cold-start grace: keep absorbing a burst still landing
                    # so it admits as one wave (a lone request pays ~10 ms).
                    self._absorb(0.12, 1)
                pending = list(self._queue)
                self._queue.clear()
            if not pending:
                return requeue

    def _loop(self) -> None:
        eng = self.engine
        chunk = eng.stream_interval
        # First tokens of waves admitted since the last dispatch: they ride
        # down with the next chunk's fetch.
        pending_firsts: list[tuple] = []
        while True:
            with self._work:
                while (
                    self._worker_exc is None
                    and not self._queue
                    and not self._live()
                    and not (self._closed and self._unfetched == 0)
                ):
                    self._work.wait()
                if self._worker_exc is not None:
                    raise self._worker_exc
                if self._closed and not self._live() and self._unfetched == 0:
                    for _, s in self._queue:
                        s.future.cancel()
                    self._queue.clear()
                    return
                pending = list(self._queue)
                self._queue.clear()
                if pending and not self._live():
                    # Idle-pool burst absorption before the first admission
                    # pass: exit after two quiet windows or 250 ms.
                    self._absorb(0.25, 2)
                    pending += self._queue
                    self._queue.clear()
            if self._pos >= eng.max_seq:
                # Waterline: drain first, so full-row retires lose no token.
                self._drain_fetches()
                self._nondecode_work = True
                self._close_gap()  # compaction runs pipeline-drained
                self._gap_phase = "compact"
                t0_obs = self._obs.now() if self._obs is not None else 0
                with self._wall("compact"), obs.attrib.tag("compact"):
                    self._compact()
                if self._obs is not None:
                    self._obs.complete("compact", t0_obs, tid="batcher", pos=self._pos)
                if self._pos >= eng.max_seq:
                    for i, s in enumerate(self._slots):
                        if s is not None:
                            self._retire(i, "length")
            requeue = self._admission_pass(pending, pending_firsts) if pending else []
            with self._work:
                self._queue[:0] = requeue
                qlen0 = len(self._queue)
            if not self._live():
                continue
            with self._work:
                # Depth gate: at most 2 chunks in flight; queue growth past
                # the requeued items breaks the wait so a new burst admits
                # before the next chunk is committed.
                while (self._worker_exc is None and self._unfetched >= 2
                       and len(self._queue) <= qlen0):
                    self._work.wait(0.1)
                if self._worker_exc is not None:
                    raise self._worker_exc
                if self._unfetched >= 2:
                    continue
                # Overshoot gate: when dispatched work covers every live
                # stream's need, another chunk is dead stepping.
                while (
                    self._worker_exc is None
                    and self._unfetched > 0
                    and len(self._queue) <= qlen0
                    and self._live()
                    and all(s.planned >= s.max_new for s in self._slots if s is not None)
                ):
                    self._work.wait(0.05)
                if self._worker_exc is not None:
                    raise self._worker_exc
            live_now = [s for s in self._slots if s is not None]
            if not live_now:
                continue
            if all(s.planned >= s.max_new for s in live_now) and (
                self._unfetched > 0 or len(self._queue) > qlen0
            ):
                continue
            self._dispatch(chunk, live_now[0].sampling, pending_firsts)
            pending_firsts = []

    def _dispatch(self, chunk: int, sampling: SamplingParams, firsts: list) -> None:
        """Enqueue one decode chunk over every row and hand its token copy
        (with the pending first tokens) to the fetch worker."""
        eng = self.engine
        # Taken before the launches: an eager chunk's host launch loop is
        # most of its time, so a drained pipeline's interval starts here.
        t_dispatch = time.monotonic()
        self._close_gap(t_dispatch)
        if self._attrib is not None:
            with self._work:
                self._dispatching = True
        t0_obs = (time.monotonic_ns()
                  if self._obs is not None or self._bb is not None else 0)
        wall = DeviceWall(eng.device) if self._attrib is not None else None
        n_steps = self._plan_steps(chunk)
        pos = torch.full((), self._pos, dtype=torch.int32, device=eng.device)
        rows = {"row_start": self._row_start}
        if self._prefix_cache is not None:
            # Prefix rows attend the one prefix copy plus their suffix
            # window (the decode kernel's return_state form and the merge).
            rows.update(prefix=self._prefix_cache, prefix_len=self._prefix_len_host,
                        prefix_rows=self._prefix_rows)
        # Valid cache slots of the first step over every row, for the
        # roofline's count of the decode kernel's work.
        kv_valid = None
        if eng._roofline is not None:
            kv_valid = sum(max(0, self._pos - r + 1) for r in self._row_start_host)
        with obs.attrib.tag("decode"):
            self._token, toks, _ = eng._decode_chunk(
                self._token, pos, self._cache, n_steps, self._gen,
                (sampling.temperature, sampling.top_k, sampling.top_p),
                eng._decode_width(self._pos + n_steps), kv_valid=kv_valid, **rows,
            )
        fetch = _Fetch(toks, wall)
        self._pos += n_steps
        for rec in (self._obs, self._bb):
            if rec is not None:
                rec.complete("decode", t0_obs, tid="batcher", steps=n_steps, pos=self._pos)
        walls, self._walls = self._walls, []
        if wall is not None:
            walls.append(("decode", fetch.wall))
        # A pure interval: nothing but the previous chunk ran on the device
        # since the last dispatch (no admission, no compaction).
        pure = not firsts and not self._nondecode_work
        self._nondecode_work = False
        for s in self._slots:
            if s is not None:
                s.planned += n_steps
        item = (fetch, list(self._slots), firsts, pure, t_dispatch, walls)
        with self._work:
            self._unfetched += 1
            self._dispatching = False
        self._fetch_q.put(item)
