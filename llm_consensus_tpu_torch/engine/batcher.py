"""Continuous batching: admission and eviction of decode streams mid-flight
(port of ``llm_consensus_tpu/engine/batcher.py``).

A pool of up to ``max_batch`` slots decodes as one batch while new requests
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
    prefill falls back to one-by-one admission. Admission takes the queue
    in priority order (a stable sort: FIFO within a class).
  * **Interleaved admission** (``prefill_budget`` > 0): on a pool that is
    decoding, a wave's prefill runs as a paced ``Engine.admission_session``,
    one budget of prompt tokens (rows x chunk) between two decode chunks,
    so residents keep decoding while the wave's KV fills; the wave's slots
    stay empty until it splices at the frontier of its last credit. One
    wave at a time; a wave whose own pacing would overrun capacity, or
    whose session does not open, admits classically; a session that fails
    requeues its streams and turns interleaving off for the batcher.
  * **Shared prefix (the one-prompt fan-out).** When an idle pool's wave
    shares a common prompt prefix of at least ``pool_prefix_min`` tokens,
    that prefix is prefilled once and kept as one dense [L, 1, P, Hkv, dh]
    KV; the wave's rows hold only their suffixes and every decode step
    merges attention over the one prefix copy with each row's own window
    exactly (the decode kernel's ``return_state``). Later waves whose every
    prompt starts with the prefix join it; other prompts admit with their
    whole prompt beside the prefix rows (``prefix_rows`` false). With the
    engine's KV pool (kv/) the idle pool also consults the radix: a wave
    that shares nothing inside it (a lone request) establishes the prefix
    the pool holds of its first prompt, sized to the resident span, so the
    establishment is a block gather; the establishment publishes the prefix
    into the pool.
  * **Compaction at the waterline.** When the frontier reaches capacity,
    every live window slides left by the common reclaimable amount, in
    place (one layer at a time through a bounded scratch copy), and the
    row starts follow.
  * **Occupancy row-bucketing** (``pool_bucket``, pools above
    ``max(8, max_batch // 8)`` rows): after 3 dispatches with the live
    streams at or below half the current row capacity, live rows move into
    the low slots and every per-row tensor is reallocated at the
    occupancy's power-of-two bucket (the old cache is freed); an admission
    that needs more rows regrows the pool before its wave splices. Every
    resize drains the fetch pipeline first.
  * **Priority preemption** (``preempt``): when the slots are full and a
    queued stream of a strictly higher class is blocked, the lowest-class,
    least-advanced resident is suspended after a drained pipeline: its
    slot frees and it requeues as ``prompt + emitted`` (the ``replay_ids``
    contract of ``submit_ids``), so a greedy stream resumes byte-identical.
  * **Fetch and emit on a worker thread**, behind a depth-2 dispatch
    pipeline: the scheduler enqueues chunk N+1 (and admissions) while the
    worker waits on chunk N's copy to the host. The scheduler thread
    launches all device work on one stream; the worker only reads each
    chunk's own freshly allocated token copy after its CUDA event.

Over a sharded engine (``Engine(mesh=)``) the pool cache is the engine's
list of per-shard caches (``Engine.new_cache``) and every cache helper below
moves all shards in lockstep; the host state (frontier, row starts, slots)
is one. As in the JAX batcher, the shared prefix runs only where every mesh
axis but ``tp`` has size 1, and an ``sp`` mesh admits rows one at a time
(each keeps its ring prefill).

Sampling shape (temperature/top_k/top_p) is per batcher; ``max_new_tokens``
and ``ignore_eos`` are per stream. A stream's seed draws its first token
(as the single-stream engine's seeded generator would); decode steps draw
from the batcher's own generator. Greedy streams produce exactly the
single-stream engine's tokens.

Pool health for a supervisor (recovery/supervisor.py): ``abandon(exc)``
fails every queued and live future without joining the (possibly wedged)
threads, ``heartbeat_age()`` and ``busy()`` read progress lock-free,
``failed_exc`` is the pool's death evidence, ``pressure_snapshot()`` the
headroom, ``set_brownout`` switches a speculative pool to its plain windows
(a classic pool has nothing cheaper than its plain decode and ignores it).

  * **Speculative rounds** (``spec``, a ``SpecConfig`` naming a buffer
    drafter: prompt lookup, or an oracle in tests and measurements): on a
    greedy pool each dispatch is a round group, per round one proposal
    program over the device token buffers and ONE target forward verifying
    ``k + 1`` positions of every row (``_spec_verify_batch``). The frontier
    advances ``k + 1`` a round, host-known; per-row acceptance is data, so
    rejected slots become holes the written-slot bitmap masks (the
    transformer's ``kv_mask``, through the plain attention op) and the
    device ``row_start`` absorbs each row's hole count. The pool-wide
    ``AdaptiveK`` walks k on the mean acceptance of live rows, the
    ``SpecGovernor`` A/Bs pooled tokens per second against bitmap-keeping
    plain windows (``_plain_chunk_masked``, also the cache's tail and the
    brownout's), and the ``spec`` fault site fires once a round. A spec pool
    shares no prefix (each row holds its whole prompt). Compaction first
    squeezes each row's holes out (its accepted slots, in order, packed to
    end at the frontier: positions were RoPE'd at write time, and the
    packed window is exactly ``[row_start, frontier)``), then slides; so a
    row's window counts its logical tokens only and a stream is never
    retired early for its holes. ``spec_snapshot()`` reports the state.

  * **The stream journal** (``journal``, recovery/journal.py): every stream
    gets a journal entry at submit (or carries the supervisor's), each
    emitted token is appended before its text is pushed, and the entry
    closes with the stream's finish (``rejected``, ``cancelled``, ``failed``
    for a failed admission, ``integrity`` for a poisoned row); a preempted
    stream's entry is sealed and a replay-seeded one opened, so a crash
    after a preemption still replays the whole stream. A pool-fatal death
    leaves the entries open: they are what the supervisor replays.
  * **Fault sites** (faults/, the engine's bound plan): before each decode
    dispatch, ``decode`` (``decode_fault``) and ``engine``: ``crash`` raises
    ``InjectedFault`` out of the loop (the fatal exit: ``failed_exc`` set,
    every future failed), ``wedge`` sleeps ``@s`` seconds without
    cooperating (600 by default); with the integrity plane on, ``corrupt``
    (``nan_logits@row=N`` poisons row N's logits in that chunk).
  * **The finite-logit sentinel** (integrity/, bound at construction): with
    the plane on every decode chunk dispatches with ``sentinel=True``; the
    fetch worker reads the [B] verdict with the chunk's tokens after the
    same CUDA event and, before the emit loop, fails each owned row whose
    logits were not all finite with ``IntegrityError("logits", ...)``
    (booked as a ``logits`` check and failure on the plane); its
    neighbours emit unchanged.

Telemetry (obs/), bound at construction as the JAX batcher binds it: the
recorder gets ``admit``, ``establish``, ``compact``, ``drain``, ``resize``,
``prefill_interleave``, ``decode`` and ``fetch`` spans and ``preempt``
instants (tid "batcher"), the flight recorder the decode and fetch spans,
the ``preempt`` instants and a dump at a fatal loop exit or an
abandonment, and the attribution ledger the stream interval of every
dispatch (an admission wave, a paced credit or a shared-prefix
establishment as ``prefill``, a compaction as ``compact``, a decode chunk
as ``decode``: :class:`DeviceWall`, read by the fetch worker after the
next chunk's copy), the ``useful`` tokens, the pool cache's bytes and the
host gaps between a drained pipeline and the next dispatch, by scheduler
phase.

Weight hot-swap (the JAX batcher's): every stream pins the engine's
resident weights (``Engine.pin_weights``) before its prefill reads them and
releases the pin on every path that removes it (retire, failure,
preemption, a requeued or failed wave), so a swap parks until the resident
set vacates; while one is pending, queued work holds at the queue head
instead of re-pinning the old weights. The shared prefix carries the
weight version that built it and is re-established after a flip. The
pressure governor (pressure/governor.py) drives ``preempt`` and
``set_brownout``. Settings are constructor arguments with the JAX knobs'
defaults; nothing here reads the environment.
"""

from __future__ import annotations

import atexit
import threading
import time
import warnings
from contextlib import contextmanager, nullcontext
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from queue import SimpleQueue
from typing import Callable, Iterable, Optional

import torch

from llm_consensus_tpu_torch import integrity, obs
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.engine.engine import (
    DeviceWall, Engine, GenerateResult, SamplingParams, _bucket, _cache_nbytes, _Fetch)
from llm_consensus_tpu_torch.engine.speculative import (
    AdaptiveK, SpecConfig, SpecGovernor, _install_spec_rows, _junk_propose, _lookup_propose,
    _oracle_propose, _plain_chunk_masked, _roll_valid, _spec_verify_batch)
from llm_consensus_tpu_torch.engine.tokenizer import StreamDecoder
from llm_consensus_tpu_torch.faults import InjectedFault
from llm_consensus_tpu_torch.models.transformer import is_shard_list
from llm_consensus_tpu_torch.ops.quant import is_quantized, kv_capacity, kv_seq_axis
from llm_consensus_tpu_torch.ops.sampling import sample_token
from llm_consensus_tpu_torch.recovery.journal import JournalEntry, StreamJournal
from llm_consensus_tpu_torch.recovery.supervisor import device_error
from llm_consensus_tpu_torch.utils.context import Context


def _fail(s, exc: BaseException) -> None:
    """Fail ``s``'s future with ``exc`` unless it is resolved already."""
    if not s.future.done():
        try:
            s.future.set_exception(exc)
        except InvalidStateError:
            pass

# Dispatches in a row with the live streams at or below half the row
# capacity before the pool shrinks (hysteresis: a transient dip does not
# pay a resize).
SHRINK_PATIENCE = 3

# _admit_batch's answer when a swap made the wave's shared prefix stale.
_STALE_PREFIX = object()


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
    # Priority class (pressure/priority.py: HIGH 0 < NORMAL 1 < LOW 2):
    # orders admission and picks preemption victims.
    priority: int = 1
    # The budgeted prompt ids without any replayed prefix: what a
    # preempted stream's resume prefills, with its emitted tokens after.
    pids: tuple = ()
    # Preempted and resumed at least once (rides the GenerateResult).
    preempted: bool = False
    # The stream's journal entry (recovery/), or None without a journal.
    jentry: Optional[JournalEntry] = None
    # Acceptance EMA of a speculative pool's row (telemetry: the pool-wide
    # controller drives k).
    spec_ema: float = 0.0
    # The weight version this stream is pinned to (Engine.pin_weights), -1
    # while unpinned.
    weight_version: int = -1


@dataclass
class _PendingWave:
    """One interleaved admission wave while its KV fills: its reserved
    ``(slot, prompt ids, stream)`` triples, the shared-prefix length it was
    planned under, and the engine's admission session whose chunks the
    scheduler paces between decode chunks."""
    batch: list
    wave_p: int
    session: object  # engine.AdmissionPrefill


@dataclass
class _SpecState:
    """Device and host state of a speculative pool. ``controller`` and
    ``governor`` are pool-wide (the verify's k is one for every row).
    ``valid`` [rows, S] is the written-slot bitmap, ``buf`` [rows, S] each
    row's logical tokens and ``blen`` [rows] their counts; ``obuf`` the
    oracle's continuations. The host row starts (``_row_start_host``) keep
    naming each row's first physical slot; the device ones absorb holes.
    ``skip_feed`` drops the governor's first arrival after a mode switch (a
    cold mode's first dispatch). The counters are written by the fetch
    worker."""
    cfg: SpecConfig
    controller: AdaptiveK
    governor: SpecGovernor
    valid: torch.Tensor
    buf: torch.Tensor
    obuf: Optional[torch.Tensor]
    blen: torch.Tensor
    skip_feed: bool = True
    rounds: int = 0           # round dispatches fetched
    row_rounds: int = 0       # live (row, round) pairs fetched
    accepted: int = 0         # accepted tokens of live rows
    disables: int = 0         # the governor locked plain (0/1)
    collapse_faults: int = 0  # injected acceptance_collapse rounds


# -- cache helpers (in place) ---------------------------------------------------
#
# Each helper takes one cache or a sharded engine's list of per-shard caches
# (engine.new_cache: one per attention position, the same leaf names, its
# heads only) and applies the same row or slot operation to every shard in
# lockstep; index tensors follow each shard to its device. The row and slot
# axes are never sharded, so the batcher's host state (frontier, row
# starts, slots) is one for all shards.


def _per_shard(fn):
    """``fn(cache, *args)`` over a list of shard caches, shard by shard (a
    second shard list among ``args``, the admission cache's, goes with it);
    the results as a list, or None."""
    def run(cache, *args):
        if is_shard_list(cache):
            out = [fn(c, *(a[i] if is_shard_list(a) else a for a in args))
                   for i, c in enumerate(cache)]
            return out if out[0] is not None else None
        return fn(cache, *args)

    run.__doc__, run.__name__ = fn.__doc__, fn.__name__
    return run


def _leaves(*sides) -> Iterable[tuple]:
    """Matching leaves of cache sides (a bf16 stack, or an int8 dict's
    codes and scales)."""
    if is_quantized(sides[0]):
        yield tuple(side["q8"] for side in sides)
        yield tuple(side["s"] for side in sides)
    else:
        yield tuple(sides)


@_per_shard
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


@_per_shard
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


def _replace_leaves(cache: dict, fn) -> None:
    """Replace every leaf of ``cache`` by ``fn(leaf)``, in the dict, one leaf
    at a time: each old leaf loses its last reference as soon as its
    replacement lands, so a resize holds at most one extra leaf."""
    for side in ("k", "v"):
        entry = cache[side]
        if is_quantized(entry):
            for name in ("q8", "s"):
                entry[name] = fn(entry[name])
        else:
            cache[side] = fn(entry)


@_per_shard
def move_row(cache: dict, src: int, dst: int) -> None:
    """Copy row ``src``'s whole window onto row ``dst`` of the pool cache, in
    place (every leaf's batch axis is 1). The two rows are disjoint slices
    of one tensor, so the copy needs no temporary; the row keeps its
    ``row_start``-relative positions, so no re-RoPE."""
    if src == dst:
        raise ValueError("move_row needs two distinct rows")
    for side in ("k", "v"):
        for (leaf,) in _leaves(cache[side]):
            leaf[:, dst].copy_(leaf[:, src])


@_per_shard
def shrink_rows(cache: dict, rows: int) -> None:
    """Reallocate every leaf of the pool cache at its first ``rows`` rows
    (fresh contiguous tensors); the old leaves are freed leaf by leaf."""
    def shrink(leaf: torch.Tensor) -> torch.Tensor:
        out = leaf.new_empty((leaf.shape[0], rows) + tuple(leaf.shape[2:]))
        out.copy_(leaf[:, :rows])
        return out

    _replace_leaves(cache, shrink)


@_per_shard
def grow_rows(cache: dict, rows: int) -> None:
    """Reallocate every leaf of the pool cache at ``rows`` rows, the old rows
    copied in and the new ones zero; the old leaves are freed leaf by leaf,
    so the regrow transient is the cache plus one new leaf."""
    def grow(leaf: torch.Tensor) -> torch.Tensor:
        out = leaf.new_zeros((leaf.shape[0], rows) + tuple(leaf.shape[2:]))
        out[:, :leaf.shape[1]].copy_(leaf)
        return out

    _replace_leaves(cache, grow)


@_per_shard
def pack_slots(cache: dict, row: int, src: torch.Tensor, dst: int) -> None:
    """Copy row ``row``'s slots ``src`` (ascending) to the contiguous run
    starting at ``dst``, in place (the gather copies first, so the ranges
    may overlap): a speculative row's holes squeezed out."""
    for side in ("k", "v"):
        for (leaf,) in _leaves(cache[side]):
            r = leaf[:, row]
            ax = kv_seq_axis(leaf) - 1
            r.narrow(ax, dst, src.numel()).copy_(r.index_select(ax, src.to(r.device)))


@_per_shard
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

    The settings take the JAX knobs' defaults: ``prefill_budget``
    (``LLMC_PREFILL_BUDGET``, 0: classic admission), ``pool_prefix`` and
    ``pool_prefix_min`` (``LLMC_POOL_PREFIX``, ``LLMC_POOL_PREFIX_MIN``),
    ``pool_bucket`` (``LLMC_POOL_BUCKET``) and ``preempt``
    (``LLMC_PRESSURE_PREEMPT``). ``journal`` (None: off) is the stream
    journal every submission records into. ``spec`` (a ``SpecConfig`` of a
    buffer drafter; None: classic) turns a greedy pool's dispatches into
    speculative round groups; a sliding-window model refuses it with one
    warning and decodes classically.
    """

    def __init__(self, engine: Engine, max_batch: int = 8, *, prefill_budget: int = 0,
                 pool_prefix: bool = True, pool_prefix_min: int = 192,
                 pool_bucket: bool = True, preempt: bool = True,
                 journal: Optional[StreamJournal] = None, spec: Optional[SpecConfig] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = max_batch
        # Interleaved admission: prompt tokens (rows x chunk) of a pending
        # wave dispatched per decode-chunk interval; 0 is classic.
        self._prefill_budget = max(0, prefill_budget)
        # The one interleaved wave in flight (admission is skipped while it
        # fills, so waves never overlap); its slots stay None until it
        # splices. Scheduler-owned.
        self._pending_wave: Optional[_PendingWave] = None
        # The streams of the admission pass in progress (taken off the
        # queue, not yet seated): a fatal exit fails them too.
        self._admitting: list = []
        # Cross-thread state (the queue, the pipeline depth, the stats) is
        # guarded by _work; scheduler-owned state (_slots writes of a
        # stream, the cache, the prefix fields, the row capacity) has one
        # writer, the scheduler thread. The fetch worker only writes slots
        # stream → None (retirement), the scheduler only None → stream
        # (and moves a row only with the pipeline drained).
        self._lock = sanitizer.make_lock("engine.batcher")
        self._work = sanitizer.make_condition("engine.batcher", self._lock)
        self._queue: list[tuple[list, _Stream]] = []  # guarded by: _work
        self._slots: list[Optional[_Stream]] = [None] * max_batch
        self._closed = False
        self._template: Optional[tuple] = None  # (temperature, top_k, top_p)
        dev = engine.device
        with torch.inference_mode():
            self._token = torch.zeros(max_batch, dtype=torch.long, device=dev)
            self._row_start = torch.zeros(max_batch, dtype=torch.int32, device=dev)
            self._prefix_rows = torch.zeros(max_batch, dtype=torch.bool, device=dev)
            self._cache = engine.new_cache(max_batch)
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self._row_start_host = [0] * max_batch
        self._pos = 0  # shared frontier (host int)
        # Occupancy row-bucketing: the per-row tensors hold _rows_cap rows
        # (slots at or past it are always None). The floor bounds the row
        # sizes at log2(max_batch / floor) + 1.
        self._rows_cap = max_batch
        self._min_rows = max(8, max_batch // 8)
        self._shrink_patience = 0
        self._rows_bucket_enabled = bool(pool_bucket) and max_batch > self._min_rows
        # Priority preemption; _preempt_req is an outside nudge (preempt()).
        self._preempt_enabled = bool(preempt)
        self._preempt_req = 0  # guarded by: _work
        self._brownout = False
        self._spec: Optional[_SpecState] = None
        if spec is not None and engine.cfg.sliding_window is not None:
            # A configuration error, told once: the bitmap's positions are
            # exact only for full attention.
            warnings.warn(f"speculative pool decode disabled for {engine.cfg.name!r}: kv_mask "
                          "holes do not compose with sliding_window attention",
                          RuntimeWarning, stacklevel=2)
        elif spec is not None:
            if spec.kind not in ("lookup", "oracle"):
                raise ValueError(f"a pool drafts from its token buffers: kind {spec.kind!r}")
            s_cap = engine.max_seq
            with torch.inference_mode():
                self._spec = _SpecState(
                    cfg=spec, controller=AdaptiveK(spec.k, adaptive=spec.adaptive),
                    governor=SpecGovernor(probe_tokens=spec.probe_tokens, enabled=spec.governor),
                    valid=torch.zeros((max_batch, s_cap), dtype=torch.bool, device=dev),
                    buf=torch.zeros((max_batch, s_cap), dtype=torch.long, device=dev),
                    obuf=(torch.zeros((max_batch, s_cap), dtype=torch.long, device=dev)
                          if spec.kind == "oracle" else None),
                    blen=torch.zeros(max_batch, dtype=torch.long, device=dev))
        # Shared-prefix pool state. Gated off for sliding-window models
        # (the window would span the prefix/suffix seam), for speculative
        # pools (the batched verify has no prefix-merge form) and, as in the
        # JAX batcher, for meshes with a non-trivial axis other than tp (an
        # sp or dp axis would put the prefix where the splice and the ring
        # prefill do not model it). On an sp mesh admission also goes one
        # row at a time, so each row keeps its ring prefill.
        shape = dict(engine.mesh.shape) if engine.mesh is not None else {}
        self._one_by_one = shape.get("sp", 1) > 1
        self._prefix_enabled = (bool(pool_prefix) and engine.cfg.sliding_window is None
                                and self._spec is None
                                and all(n == 1 for a, n in shape.items() if a != "tp"))
        self._prefix_min = pool_prefix_min
        self._prefix_ids: Optional[tuple] = None
        self._prefix_cache: Optional[dict] = None
        self._prefix_len_host = 0
        self._prefix_weight_version = -1  # the weight version that built it
        # decode_s counts arrival-to-arrival intervals (dispatch-to-arrival
        # after a drained pipeline) of chunks that ran alone on the device
        # (no admission or compaction since the last dispatch) and emitted
        # tokens; admit_s/establish_s the scheduler's
        # admission-prefill and prefix-establishment walls (admit_tokens the
        # prompt tokens admission prefilled, admitted the streams it
        # installed; establish_tokens the prefix tokens established);
        # absorb_s the bounded burst-absorption pauses; preemptions the
        # streams suspended for a higher class; compactions the waterline
        # slides.
        self.stats = {  # guarded by: _work
            "decode_tokens": 0, "decode_s": 0.0, "admit_s": 0.0, "admit_tokens": 0,
            "admitted": 0, "establish_s": 0.0, "establish_tokens": 0, "absorb_s": 0.0,
            "preemptions": 0, "compactions": 0,
        }
        self._prev_arrival: Optional[float] = None
        self._unfetched = 0  # guarded by: _work (dispatched chunks not yet emitted)
        self._nondecode_work = False  # admission/compaction since last dispatch
        self._worker_exc: Optional[BaseException] = None  # guarded by: _work
        # Pool-death evidence: set by the loop's fatal exit and abandon().
        self.failed_exc: Optional[BaseException] = None
        # Progress heartbeat: stats updates (admissions, fetch arrivals)
        # and decode dispatches advance it; submissions do not.
        self._beat = time.monotonic()
        # Telemetry planes, bound once: a plane off costs one None check
        # per chunk on the scheduler and fetch loops.
        self._obs = obs.recorder()
        self._bb = obs.blackbox.ring()
        self._attrib = obs.attrib.ledger()
        # Stream journal and integrity plane, bound once: without them every
        # stream's jentry stays None (one check per emitted token) and decode
        # chunks dispatch without the sentinel.
        self._journal = journal
        self._integrity = integrity.plane()
        self._book_cache_bytes()
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

    def _book_cache_bytes(self) -> None:
        """The pool cache's bytes into the attribution ledger (at
        construction and after every resize)."""
        if self._attrib is not None:
            self._attrib.update_component(f"pool_cache:{self.engine.cfg.name}",
                                          _cache_nbytes(self._cache))

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: str, sampling: SamplingParams = SamplingParams(),
               ctx: Optional[Context] = None,
               on_text: Optional[Callable[[str], None]] = None, *,
               priority: int = 1, trace_id: Optional[str] = None) -> "Future[GenerateResult]":
        """Queue a prompt; the Future resolves to the single-stream API's
        GenerateResult shape."""
        eng = self.engine
        prompt_ids, truncated = eng._budget_prompt(
            eng.tokenizer.encode(prompt), sampling.max_new_tokens)
        return self.submit_ids(prompt_ids, sampling, ctx=ctx, on_text=on_text,
                               truncated=truncated, priority=priority, trace_id=trace_id)

    def submit_ids(self, prompt_ids: list, sampling: SamplingParams = SamplingParams(),
                   ctx: Optional[Context] = None,
                   on_text: Optional[Callable[[str], None]] = None, *,
                   truncated: bool = False, replay_ids: "tuple | list" = (),
                   priority: int = 1,
                   jentry: Optional[JournalEntry] = None,
                   trace_id: Optional[str] = None) -> "Future[GenerateResult]":
        """Token-level submit (``prompt_ids`` already budgeted).

        ``replay_ids`` resumes a stream decoded partway elsewhere (a dead
        pool's, recovery/): they join the prefill context (re-established
        at admission, not re-decoded), count against ``max_new`` as if this
        pool had produced them, and are pre-fed through the stream decoder
        and ``on_text`` (which the supervisor's shim dedups), so a greedy
        stream continues byte-identical and the final text covers the whole
        generation. ``jentry`` carries the caller's journal entry; without
        one, a batcher with a journal opens a fresh entry here, carrying the
        request's ``trace_id`` (a migrated stream's is how ``seal_stream``
        finds it)."""
        eng = self.engine
        if not prompt_ids:
            raise ValueError("empty prompt")
        if jentry is None and self._journal is not None:
            jentry = self._journal.record(list(prompt_ids), sampling, trace=trace_id)
        shape = (sampling.temperature, sampling.top_k, sampling.top_p)
        stream = _Stream(
            future=Future(), sampling=sampling, ctx=ctx or Context.background(),
            on_text=on_text, prompt_tokens=len(prompt_ids),
            decoder=StreamDecoder(eng.tokenizer), submitted=time.monotonic(),
            truncated=truncated,
            max_new=min(sampling.max_new_tokens, eng.max_seq - len(prompt_ids)),
            priority=int(priority), pids=tuple(prompt_ids), jentry=jentry,
        )
        ids = list(prompt_ids)
        if replay_ids:
            if self._attrib is not None:
                self._attrib.token_event("crash_replay", len(replay_ids))
            ids += list(replay_ids)
            stream.out_ids = list(replay_ids)
            # The prefill-sampled first token is one new step on top of the
            # replayed ones.
            stream.planned = 1 + len(replay_ids)
            if on_text is not None:
                for tok in replay_ids:
                    text = stream.decoder.push(tok)
                    if text:
                        stream.parts.append(text)
                        on_text(text)
            if len(stream.out_ids) >= stream.max_new:
                # The dead incarnation produced everything it was allowed to.
                stream.future.set_result(self._result(stream))
                return stream.future
        with self._work:
            if self._closed:
                if jentry is not None:
                    jentry.close("rejected")
                raise RuntimeError("batcher is closed")
            if self._template is None:
                self._template = shape
            elif shape != self._template:
                if jentry is not None:
                    jentry.close("rejected")
                raise ValueError(
                    f"sampling shape {shape} does not match this batcher's "
                    f"{self._template} (temperature/top_k/top_p are per-batcher; "
                    "max_new_tokens/ignore_eos are per-stream)")
            # No heartbeat here: a submission is not pool progress.
            self._queue.append((ids, stream))
            self._work.notify()
        return stream.future

    def close(self) -> None:
        atexit.unregister(self.close)
        with self._work:
            self._closed = True
            for _, s in self._queue:
                s.future.cancel()
                if s.jentry is not None:
                    s.jentry.close("cancelled")
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

    # -- pool health -------------------------------------------------------------

    def heartbeat_age(self) -> float:
        """Seconds since the pool last made progress (an admission, a
        decode dispatch or a fetch arrival)."""
        return time.monotonic() - self._beat

    def busy(self) -> bool:
        """Whether the pool has work that should advance the heartbeat.
        Lock-free on purpose: a watchdog calls it to find a scheduler wedged
        while holding the lock; a stale read delays it by one poll."""
        return (self._unfetched > 0  # lint-ok: GS01 watchdog must not block
                or self._pending_wave is not None
                or any(s is not None for s in self._slots)
                or bool(self._queue))  # lint-ok: GS01 watchdog must not block

    def abandon(self, exc: BaseException) -> None:
        """Declare the pool dead without joining its threads (they may be
        wedged in device work that never returns): record ``exc`` as the
        failure, fail every queued, pending and live future, and clear the
        slots so a fetch worker that wakes later drops its stale tokens by
        the owner check. Idempotent; ``close()`` stays the graceful path."""
        atexit.unregister(self.close)
        with self._work:
            first = self.failed_exc is None
            if first:
                self.failed_exc = exc
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
            live = [s for s in self._slots if s is not None]
            for i in range(len(self._slots)):
                self._slots[i] = None
            wave, self._pending_wave = self._pending_wave, None
            self._work.notify_all()
        if first and self._bb is not None:
            self._bb.instant("engine_abandon", tid="batcher", error=repr(exc))
            self._bb.dump("engine_wedge", extra={"error": repr(exc)})
        if self._attrib is not None and live:
            # Their emitted tokens are work lost with the pool.
            self._attrib.token_event("abandoned", sum(len(s.out_ids) for s in live))
        for _, s in queued:
            if not s.future.cancel():
                _fail(s, exc)
        for s in live + ([s for _, _, s in wave.batch] if wave is not None else []):
            self._unpin_stream(s)
            _fail(s, exc)

    # -- preemption (pressure/) -------------------------------------------------

    def preempt(self, max_victims: int = 1) -> None:
        """Ask the scheduler to suspend up to ``max_victims`` of the
        lowest-class, least-advanced residents at its next safe point (after
        a drained pipeline, so no fetched token is lost). It acts only when
        queued work of a strictly higher class is blocked; the victims'
        futures stay pending and resolve when their resumed streams end."""
        with self._work:
            if self._closed:
                return
            self._preempt_req = max(self._preempt_req, max(1, max_victims))
            self._work.notify()

    # The pressure governor's spelling.
    request_preempt = preempt

    def set_brownout(self, on: bool) -> None:
        """The pressure governor's brownout flag: a speculative pool
        dispatches its plain (bitmap-keeping) windows while it is set. A
        classic pool ignores it: nothing is cheaper than its plain decode."""
        self._brownout = bool(on)

    def spec_snapshot(self) -> Optional[dict]:
        """The pool's speculation state (the JAX keys; ``metrics.json``'s
        ``spec`` block), or None for a classic pool. The counters are the
        fetch worker's plain int bumps: a telemetry read."""
        sp = self._spec
        if sp is None:
            return None
        return {
            "kind": sp.cfg.kind, "k": sp.controller.k, "rounds": sp.rounds,
            "accepted": sp.accepted,
            "mean_accepted": round(sp.accepted / sp.row_rounds, 3) if sp.row_rounds else None,
            "accept_ema": round(sp.controller.ema, 3), "governor": sp.governor.state,
            "governor_disables": sp.disables, "collapse_faults": sp.collapse_faults,
            "stream_emas": [round(s.spec_ema, 3) for s in self._slots if s is not None],
        }

    def pressure_snapshot(self) -> dict:
        """Headroom for a pressure governor: live streams, row capacity,
        queued streams (a pending wave's included) and lifetime
        preemptions. The lock is taken with a bound, so a wedged pool never
        hangs its reader (the stale read is then lock-free)."""
        wave = self._pending_wave
        got = self._work.acquire(timeout=0.2)
        try:
            queued = len(self._queue)  # lint-ok: GS01 bounded-acquire fallback
            preemptions = self.stats["preemptions"]  # lint-ok: GS01 bounded-acquire fallback
        finally:
            if got:
                self._work.release()
        return {"live": sum(1 for s in self._slots if s is not None), "cap": self._rows_cap,
                "queued": queued + (len(wave.batch) if wave is not None else 0),
                "preemptions": preemptions}

    def _plan_preempt(self, requeue: list, firsts: list) -> list:
        """When the slots are full and blocked streams (``requeue`` and the
        queue) outrank residents, pick victims: lowest class first, least
        progress first within a class, one per blocked higher-class stream,
        never one at or above the class it unblocks. Returns the resume
        queue entries (empty when nothing is justified)."""
        with self._work:
            ext, self._preempt_req = self._preempt_req, 0
            queued_pri = [s.priority for _, s in self._queue]
        live = [(i, s) for i, s in enumerate(self._slots[:self._rows_cap]) if s is not None]
        if not live:
            return []
        slots_full = len(live) == self._rows_cap and self._pending_wave is None
        if not slots_full and not ext:
            return []
        blocked = sorted([s.priority for _, s in requeue] + queued_pri)
        if not blocked:
            return []
        cand = sorted(live, key=lambda t: (-t[1].priority, len(t[1].out_ids)))
        # Full slots free one slot per blocked higher-class stream; a nudge
        # alone keeps its own cap (a resume re-prefills: real work).
        budget = len(blocked) if slots_full else min(ext, len(blocked))
        victims: list[int] = []
        bi = 0
        for slot, s in cand:
            if bi >= len(blocked) or len(victims) >= budget:
                break
            if s.priority > blocked[bi]:
                victims.append(slot)
                bi += 1
        if not victims:
            return []
        # The victims' emitted tokens become their resume context: no
        # fetched token may be in flight.
        self._drain_fetches()
        self._nondecode_work = True
        self._gap_phase = "preempt"
        return self._preempt_slots(victims, firsts)

    def _preempt_slots(self, victims: list, firsts: list) -> list:
        """Suspend the victim slots (scheduler thread, pipeline drained):
        free the row and build the resume entry ``pids + emitted``, which
        re-admission prefills so a greedy stream continues byte-identical.
        A victim's first token still waiting in ``firsts`` is dropped (the
        resume samples it again). A journaled victim's entry is sealed and a
        fresh one seeded with the emitted tokens takes its place."""
        entries: list = []
        for slot in victims:
            s = self._slots[slot]
            if s is None:
                continue  # retired between planning and here
            self._slots[slot] = None
            # Leaving residency releases the pin; the resume re-pins at
            # re-admission (possibly onto swapped-in weights).
            self._unpin_stream(s)
            for _slots, _fetch, owners in firsts:
                for j, owner in enumerate(owners):
                    if owner is s:
                        owners[j] = None
            snapshot = list(s.out_ids)
            if len(snapshot) >= s.max_new:
                # Nothing left to decode: resolve, do not resume.
                s.finish = "length"
                if not s.future.done():
                    try:
                        s.future.set_result(self._result(s))
                    except InvalidStateError:
                        pass
                continue
            if s.jentry is not None and self._journal is not None:
                # Seal the old incarnation's entry (late appends drop) and
                # open one seeded with the snapshot, the prefix the resume
                # re-prefills: a crash after the preemption still replays
                # the whole stream.
                old = s.jentry
                old.seal()
                s.jentry = self._journal.record(list(s.pids), s.sampling, tokens=snapshot,
                                                replay_of=old, trace=old.trace)
                old.close("preempted")
            # The resume prefill covers the emitted tokens plus one freshly
            # sampled token (submit_ids' replay accounting).
            s.planned = len(snapshot) + 1
            s.preempted = True
            entries.append((list(s.pids) + snapshot, s))
            if self._attrib is not None:
                self._attrib.token_event("preempt_replay", len(snapshot))
            for rec in (self._obs, self._bb):
                if rec is not None:
                    rec.instant("preempt", tid="batcher", slot=slot, priority=s.priority,
                                progress=len(snapshot))
            if self._obs is not None:
                self._obs.count("pressure.preemptions")
        if entries:
            self._stat_add(preemptions=len(entries))
        return entries

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
        self._pin_stream(s)  # before the prefill reads the weights
        try:
            last_logits, pcache = eng._prefill_ids(prompt_ids)
            return self._install_wave([(slot, prompt_ids, s)], 0, last_logits, pcache,
                                      _bucket(len(prompt_ids), eng.max_seq))
        except BaseException:
            self._unpin_stream(s)
            raise

    def _establish_prefix(self, prefix_ids: list[int]) -> bool:
        """Prefill the wave's common prefix once and install it as the
        pool's shared-prefix KV (pool idle). Returns False, state cleared,
        when it does not fit, its prefill fails, or a weight swap flipped
        under it; a device error (see ``recovery.device_error``) or a
        failed KV-pool publish raises."""
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
        # Pinned from the prefill to the version stamp: a swap arriving
        # meanwhile parks, so the KV, its pool blocks and the stamp are all
        # of version ``v``.
        v = eng.pin_weights()
        try:
            try:
                _, pcache = eng._prefill_ids(prefix_ids)
                self._prefix_cache = extract_prefix(pcache, p_cap)
            except Exception as exc:  # noqa: BLE001 — establishment is an optimization
                self._clear_prefix()
                if device_error(exc):
                    # A device fault (a failed KV-pool gather among them) is
                    # no optimization failing: it fails the batcher, as a
                    # decode fault does.
                    raise
                # Otherwise every later idle wave repeats the failing prefill.
                warnings.warn("shared-prefix establishment prefill failed; disabling pool "
                              "prefix sharing for this batcher", RuntimeWarning, stacklevel=2)
                self._prefix_enabled = False
                return False
            if eng._kv_pool is not None:
                # The KV pool keeps the prefix for later waves, as the JAX
                # batcher retains it (a publish of the blocks it lacks).
                # Outside the inner try: a failed publish raises.
                eng._retain_prefix(prefix_ids, pcache)
            self._prefix_ids = tuple(prefix_ids)
            self._prefix_len_host = p
            # The weight version whose params computed this KV: the
            # scheduler clears the prefix when a swap changes it.
            self._prefix_weight_version = v
        finally:
            eng.unpin_weights()  # the last unpin applies a parked swap
        if eng.weight_version != v:
            # It flipped at that unpin: the KV is the old weights' (the
            # flip evicted its cold pool blocks), so the wave admits whole.
            self._clear_prefix()
            return False
        return True

    def _clear_prefix(self) -> None:
        self._prefix_cache = None
        self._prefix_ids = None
        self._prefix_len_host = 0
        self._prefix_weight_version = -1

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
        Returns the firsts entries, None when the batched prefill failed
        (the caller admits one by one), or ``_STALE_PREFIX`` when the
        prefix is older than the weights the streams pinned."""
        eng = self.engine
        rows = [ids for _, ids, _ in batch]
        pad_rows = rows + [rows[0]] * (self._wave_k_pad(len(rows)) - len(rows))
        for _, _, s in batch:
            self._pin_stream(s)  # before the prefill reads the weights
        if prefix_p and batch[0][2].weight_version != self._prefix_weight_version:
            # A swap flipped on an idle pool between the prefix's version
            # check and these pins: the prefix is the old weights' KV.
            # Nothing changed yet; the caller requeues the wave.
            for _, _, s in batch:
                self._unpin_stream(s)
            self._clear_prefix()
            return _STALE_PREFIX
        try:
            if prefix_p:
                last_logits, pcache, width = eng._prefill_rows_suffix(
                    [r[prefix_p:] for r in pad_rows], self._prefix_cache, prefix_p)
            else:
                last_logits, pcache, width = eng._prefill_rows(pad_rows)
        except Exception:  # noqa: BLE001
            # Nothing changed yet: one-by-one admission makes a failure
            # cost one stream, not the wave (and re-pins). Failures past
            # this point (splice, install) are pool-fatal.
            for _, _, s in batch:
                self._unpin_stream(s)
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
        if self._spec is not None:
            self._spec_install(batch, slots, dsts, samples)
        owners = []
        for i, (slot, _ids, s) in enumerate(batch):
            self._row_start_host[slot] = dsts[i]
            self._slots[slot] = s
            owners.append(s)
        return (slots, _Fetch(samples), owners)

    def _spec_install(self, batch: list, slots: list, dsts: list, samples: torch.Tensor) -> None:
        """Admitted rows' speculative state: bitmap row = the spliced prompt
        window, token buffer = prompt ids + the first token, ``blen`` = n +
        1; an oracle pool's continuations are written from the host
        (tests and measurements only)."""
        sp = self._spec
        eng = self.engine
        slot_t = eng.to_device(slots)
        prompts = [list(ids) for _, ids, _ in batch]
        _install_spec_rows(sp.valid, sp.buf, sp.blen, slot_t, dsts, self._pos, prompts, samples)
        for _, _, s in batch:
            s.spec_ema = 0.0
        if sp.obuf is not None and sp.cfg.oracle is not None:
            s_cap = eng.max_seq
            for slot, ids in zip(slots, prompts):
                row = (ids + list(sp.cfg.oracle(list(ids))) + [0] * s_cap)[:s_cap]
                sp.obuf[slot] = eng.to_device(row)

    # -- interleaved admission ---------------------------------------------------

    def _begin_wave(self, batch: list, wave_p: int) -> bool:
        """Open the admission session of an interleaved wave, which
        ``_advance_wave`` paces between decode chunks. False (the caller
        admits classically) when the wave would not fit the frontier after
        the decode growth its own pacing implies, or when the session does
        not open. The streams pin the weights here: the session's chunks
        read them."""
        eng = self.engine
        rows = [ids for _, ids, _ in batch]
        k_pad = self._wave_k_pad(len(rows))
        pad_rows = rows + [rows[0]] * (k_pad - len(rows))
        if wave_p:
            w_req = _bucket(max(len(r) - wave_p for r in rows), eng.max_seq)
        else:
            w_req = eng._rows_bucket(max(len(r) for r in rows))
        # The splice happens at the frontier of the last credit: one decode
        # chunk per budget of prefill, plus the depth-2 pipeline's slack.
        total = sum(len(r) - wave_p for r in pad_rows)
        steps = max(1, -(-total // max(1, self._prefill_budget)))
        growth = (steps + 2) * eng.stream_interval
        if any((self._pos + growth - (len(ids) - wave_p)) + w_req > eng.max_seq
               for _, ids, _ in batch):
            return False
        for _, _, s in batch:
            self._pin_stream(s)
        try:
            if wave_p:
                session = eng.admission_session([r[wave_p:] for r in pad_rows],
                                                prefix_cache=self._prefix_cache,
                                                prefix_len=wave_p)
            else:
                session = eng.admission_session(pad_rows)
        except Exception:  # noqa: BLE001 — the classic path has the fallback
            for _, _, s in batch:
                self._unpin_stream(s)  # classic admission re-pins
            return False
        self._pending_wave = _PendingWave(batch=batch, wave_p=wave_p, session=session)
        if self._obs is not None:
            self._obs.instant("prefill_interleave_start", tid="batcher", streams=len(batch),
                              prefix=wave_p, tokens=session.remaining_tokens)
        return True

    def _advance_wave(self, firsts: list, exhaust: bool) -> None:
        """Dispatch one credit (``prefill_budget`` prompt tokens) of the
        pending wave, or with ``exhaust`` (nothing live to overlap) the
        rest of it. After the last credit, splice at the current frontier,
        install the streams and attach their first tokens to ``firsts``."""
        wave = self._pending_wave
        eng = self.engine
        self._nondecode_work = True
        t_adm = self._admission_starts()
        t0_obs = self._obs.now() if self._obs is not None else 0
        try:
            with self._wall("prefill"), obs.attrib.tag("prefill"):
                done = wave.session.step(None if exhaust else self._prefill_budget)
                finished = wave.session.finish() if done else None
            if self._obs is not None:
                self._obs.complete("prefill_interleave", t0_obs, tid="batcher", done=done,
                                   exhaust=exhaust)
            if not done:
                self._stat_add(admit_s=time.monotonic() - t_adm)
                return
            last_logits, pcache, width = finished
        except Exception:  # noqa: BLE001 — the classic path admits them
            self._stat_add(admit_s=time.monotonic() - t_adm)
            self._wave_fallback(wave)
            return
        members = [len(ids) - wave.wave_p for _, ids, _ in wave.batch]
        if any(n > self._pos or (self._pos - n) + width > eng.max_seq for n in members):
            # Decode outran the headroom _begin_wave planned: requeue (the
            # prefill is wasted; a clamped splice would misalign rows).
            self._pending_wave = None
            self._stat_add(admit_s=time.monotonic() - t_adm)
            for _, _, s in wave.batch:
                self._unpin_stream(s)  # requeued: re-pins at re-admission
            with self._work:
                self._queue[:0] = [(ids, s) for _, ids, s in wave.batch]
                self._work.notify()
            return
        # The wave stays pending until the install lands: a pool-fatal
        # splice failure reaches these streams through _pending_wave.
        installed = False
        try:
            with self._wall("prefill"), obs.attrib.tag("prefill"):
                entry = self._install_wave(wave.batch, wave.wave_p, last_logits, pcache, width)
            installed = True
        finally:
            deltas = {"admit_s": time.monotonic() - t_adm}
            if installed:
                deltas.update(admitted=len(wave.batch), admit_tokens=sum(members))
                self._pending_wave = None
            self._stat_add(**deltas)
        firsts.append(entry)
        if self._obs is not None:
            self._obs.complete("admit", t0_obs, tid="batcher", streams=len(wave.batch),
                               prefix=wave.wave_p, ok=True, interleaved=True,
                               resumed=sum(st.preempted for _, _, st in wave.batch))
            self._obs.count("prefill.interleaved_tokens", sum(members))

    def _wave_fallback(self, wave: _PendingWave) -> None:
        """A wave's paced prefill failed: requeue its streams at the head
        and turn interleaving off for this batcher, so the retry takes the
        classic path (whose one-by-one fallback fails at most one stream)."""
        self._pending_wave = None
        warnings.warn("interleaved admission prefill failed; reverting to classic "
                      "admission for this batcher", RuntimeWarning, stacklevel=2)
        self._prefill_budget = 0
        for _, _, s in wave.batch:
            self._unpin_stream(s)  # classic retry re-pins
        with self._work:
            self._queue[:0] = [(ids, s) for _, ids, s in wave.batch]
            self._work.notify()

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
        if s.jentry is not None:
            # Every resolution funnels through here: the entry retires with
            # the stream's finish, so only unresolved streams stay replay
            # candidates.
            s.jentry.close(s.finish)
        return GenerateResult(
            token_ids=s.out_ids, text=text, finish_reason=s.finish,
            prompt_tokens=s.prompt_tokens,
            latency_ms=(time.monotonic() - s.submitted) * 1000,
            truncated_prompt=s.truncated, preempted=s.preempted,
        )

    # -- weight-version pinning (hot-swap) ----------------------------------------

    def _pin_stream(self, s: _Stream) -> None:
        """Pin ``s`` to the engine's resident weights before its prefill
        reads them: a concurrent swap then parks instead of flipping under
        the admission. Idempotent per stream."""
        if s.weight_version < 0:
            s.weight_version = self.engine.pin_weights()

    def _unpin_stream(self, s: Optional[_Stream]) -> None:
        """Release ``s``'s pin (idempotent: every removal path calls it).
        The last unpin applies a parked swap."""
        if s is not None and s.weight_version >= 0:
            s.weight_version = -1
            self.engine.unpin_weights()

    def _retire(self, slot: int, finish: str) -> None:
        s = self._slots[slot]
        if s is None:
            return
        s.finish = finish
        self._slots[slot] = None
        self._unpin_stream(s)
        # First writer wins: the scheduler's failure path may have failed
        # this future already.
        if not s.future.done():
            try:
                s.future.set_result(self._result(s))
            except InvalidStateError:
                pass

    def _fail_slot(self, slot: int, exc: BaseException) -> None:
        """Fail exactly one slot's stream with ``exc`` (the integrity
        plane's containment unit): the slot frees, the journal entry retires
        as ``integrity``, so no replay resurrects a poisoned stream, and no
        other slot is touched."""
        s = self._slots[slot]
        if s is None:
            return
        s.finish = "integrity"
        self._slots[slot] = None
        self._unpin_stream(s)
        if s.jentry is not None:
            s.jentry.close("integrity")
        _fail(s, exc)

    def _emit(self, slot: int, tok: int, eos: int) -> bool:
        """Hand one token to its stream; True when it was appended."""
        s = self._slots[slot]
        if s is None:
            return False
        if tok == eos and not s.sampling.ignore_eos:
            self._retire(slot, "eos")
            return False
        s.out_ids.append(tok)
        if s.jentry is not None:
            s.jentry.append(tok)  # write-ahead journal (recovery/)
        if s.on_text is not None:
            text = s.decoder.push(tok)
            if text:
                s.parts.append(text)
                s.on_text(text)
        if len(s.out_ids) >= s.max_new:
            self._retire(slot, "length")
        return True

    def _stat_add_locked(self, **deltas) -> None:
        """Under ``_work``: accumulate stats. Every update is progress, so
        it advances the heartbeat."""
        sanitizer.assert_held(self._work)
        for k, v in deltas.items():
            self.stats[k] += v
        self._beat = time.monotonic()

    def _stat_add(self, **deltas) -> None:
        with self._work:
            self._stat_add_locked(**deltas)

    # -- frontier and row capacity ----------------------------------------------

    def _rows_target(self, n: int) -> int:
        """The power-of-two row bucket covering ``n`` live streams, floored
        at ``_min_rows`` and capped at ``max_batch``."""
        t = self._min_rows
        while t < n:
            t *= 2
        return min(t, self.max_batch)

    def _resize_to(self, target: int) -> None:
        """Reallocate every per-row tensor at ``target`` rows. The caller
        has drained the fetch pipeline: a row moving slots would otherwise
        fail an in-flight chunk's owner check and lose its tokens. A shrink
        first moves the live rows at or past ``target`` into free low slots
        (cache row, token, row start, prefix flag, host row start and
        stream together); the old tensors are freed."""
        if target == self._rows_cap:
            return
        t0_obs = self._obs.now() if self._obs is not None else 0
        cap = self._rows_cap
        if target < cap:
            frees = [i for i in range(target) if self._slots[i] is None]
            for src in [i for i in range(target, cap) if self._slots[i] is not None]:
                dst = frees.pop(0)
                move_row(self._cache, src, dst)
                for t in (self._token, self._row_start, self._prefix_rows, *self._spec_rows()):
                    t[dst] = t[src]
                self._row_start_host[dst] = self._row_start_host[src]
                self._slots[dst], self._slots[src] = self._slots[src], None
            shrink_rows(self._cache, target)
            self._token = self._token[:target].clone()
            self._row_start = self._row_start[:target].clone()
            self._prefix_rows = self._prefix_rows[:target].clone()
            self._spec_resize(lambda t: t[:target].clone())
        else:
            grow_rows(self._cache, target)
            pad = target - cap
            self._token = torch.cat([self._token, self._token.new_zeros(pad)])
            self._row_start = torch.cat([self._row_start, self._row_start.new_zeros(pad)])
            self._prefix_rows = torch.cat([self._prefix_rows, self._prefix_rows.new_zeros(pad)])
            self._spec_resize(
                lambda t: torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]))
        self._rows_cap = target
        self._book_cache_bytes()
        if self._obs is not None:
            self._obs.complete("resize", t0_obs, tid="batcher", rows=target, before=cap)

    def _spec_rows(self) -> tuple:
        """The speculative pool's per-row tensors (empty for a classic pool)."""
        sp = self._spec
        if sp is None:
            return ()
        return tuple(t for t in (sp.valid, sp.buf, sp.obuf, sp.blen) if t is not None)

    def _spec_resize(self, fn) -> None:
        sp = self._spec
        if sp is None:
            return
        sp.valid, sp.buf, sp.blen = fn(sp.valid), fn(sp.buf), fn(sp.blen)
        if sp.obuf is not None:
            sp.obuf = fn(sp.obuf)

    def _maybe_shrink(self) -> None:
        """Shrink the row bucket once the live streams have stayed at or
        below half the current capacity for ``SHRINK_PATIENCE`` dispatches."""
        live_n = sum(1 for s in self._slots if s is not None)
        target = self._rows_target(live_n)
        if live_n and target * 2 <= self._rows_cap:
            self._shrink_patience += 1
            if self._shrink_patience >= SHRINK_PATIENCE:
                self._shrink_patience = 0
                self._resize_drained(target)
        else:
            self._shrink_patience = 0

    def _resize_drained(self, target: int) -> None:
        """Drain the fetch pipeline, then ``_resize_to(target)`` (booked as
        compaction-family device work)."""
        self._drain_fetches()
        self._nondecode_work = True
        self._close_gap()  # the resize runs pipeline-drained
        self._gap_phase = "resize"
        with self._wall("compact"), obs.attrib.tag("compact"):
            self._resize_to(target)

    def _compact(self) -> None:
        """Give live rows fresh runway when the frontier hits capacity:
        retire rows that already fill the cache, slide every window left by
        the common reclaimable amount, re-align the row starts and pull
        the frontier back. Windows keep their offsets: no re-RoPE."""
        eng = self.engine
        if self._spec is not None:
            self._squeeze_holes()
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
        if self._spec is not None:
            # The bitmap slides with the KV it describes; the columns that
            # wrap came from below every live row's base (False). The
            # buffers are logical: untouched.
            _roll_valid(self._spec.valid, shift)
        self._stat_add(compactions=1)

    def _squeeze_holes(self) -> None:
        """Pack each live speculative row's written slots (its bitmap, in
        order: its logical positions 0..blen-2) into the run ending at the
        frontier, before compaction measures windows. The KV was RoPE'd at
        write time, and the run starts at the device row start (the
        invariant row_start = frontier - blen + 1), so positions stay exact
        and the row's window is its logical length. Runs pipeline-drained:
        one host read of ``blen``."""
        sp = self._spec
        blens = sp.blen.tolist()
        ar = torch.arange(sp.valid.shape[1], device=sp.valid.device)
        for i, s in enumerate(self._slots[:self._rows_cap]):
            if s is None:
                continue
            base = self._pos - (blens[i] - 1)
            if base == self._row_start_host[i]:
                continue  # no holes
            src = sp.valid[i].nonzero()[:, 0]
            if src.numel() != blens[i] - 1:
                raise RuntimeError(f"speculative row {i}: bitmap holds {src.numel()} slots, "
                                   f"its buffer {blens[i] - 1}")
            pack_slots(self._cache, i, src, base)
            sp.valid[i] = (ar >= base) & (ar < self._pos)
            self._row_start_host[i] = base
            self._row_start[i] = base

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
            and self._unfetched == 0  # lint-ok: GS01 monotone read (heuristic only)
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
            self.failed_exc = exc  # before any future fails: the evidence
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
                    self._unpin_stream(s)
                    _fail(s, exc)
            wave, self._pending_wave = self._pending_wave, None
            if wave is not None:
                # A filling wave's streams are in neither the queue nor the
                # slots.
                for _, _, s in wave.batch:
                    self._unpin_stream(s)
                    _fail(s, exc)
            for _, s in self._admitting:
                self._unpin_stream(s)
                _fail(s, exc)  # those the pass had seated are failed above
            raise
        else:
            self._fetch_q.put(None)
            self._fetch_thread.join(timeout=120)

    def _fetch(self, fetch: _Fetch, owners: list, firsts: list, eos: int) -> tuple[int, float]:
        """Wait for one chunk's tokens (and the first tokens of waves
        admitted before it), emit them; returns ``(tokens emitted, arrival
        time)``, the time taken before the emit loop. With the sentinel's
        verdict on the chunk, each owned row whose logits were not all
        finite fails typed before anything is emitted."""
        first_vals = [f.values() for _, f, _ in firsts]
        cols = list(zip(*fetch.values()))  # [n_steps][B] → [B][n_steps]
        verdict = fetch.verdict()
        t_arrival = time.monotonic()
        if verdict is not None and self._integrity is not None:
            self._integrity.check("logits")
            for i, row_ok in enumerate(verdict):
                if row_ok or i >= len(owners) or owners[i] is None:
                    continue
                if self._slots[i] is not owners[i]:
                    continue
                self._integrity.failure("logits", f"non-finite logits in decode row {i}")
                self._fail_slot(i, integrity.IntegrityError(
                    "logits", f"non-finite logits detected in decode row {i}"))
        emitted, appended = self._emit_firsts(firsts, first_vals, eos)
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

    def _emit_firsts(self, firsts: list, first_vals: list, eos: int) -> tuple[int, int]:
        """Emit the admitted waves' first tokens that rode this fetch (owner
        checked); returns ``(emitted, appended)``."""
        emitted = appended = 0
        for (slots, _, wave_owners), vals in zip(firsts, first_vals):
            for slot, owner, val in zip(slots, wave_owners, vals):
                # None: the stream was preempted before this first token.
                if owner is not None and self._slots[slot] is owner:
                    appended += self._emit(slot, val, eos)
                    emitted += 1
        return emitted, appended

    def _fetch_spec(self, fetch: _Fetch, owners: list, firsts: list,
                    eos: int) -> tuple[int, float]:
        """Fetch and emit one speculative round group: per round, row i
        emits its accepted prefix (owner checked, as the classic emit
        loop); the pool's controller observes the mean acceptance of the
        rows still live (a retired row keeps stepping, and its post-EOS
        repetition would over-accept), each stream's EMA its own."""
        first_vals = [f.values() for _, f, _ in firsts]
        rounds = fetch.values()  # [R][B][k + 2]
        t_arrival = time.monotonic()
        emitted, appended = self._emit_firsts(firsts, first_vals, eos)
        sp = self._spec
        k_used = len(rounds[0][0]) - 2
        total_acc = rejected = overshoot = 0
        for rnd in rounds:
            live = acc = 0
            for i, owner in enumerate(owners):
                if owner is None:
                    continue
                row = rnd[i]
                ai = row[-1]
                if self._slots[i] is owner:
                    owner.spec_ema += 0.25 * (ai - owner.spec_ema)
                    live += 1
                    acc += ai
                taken = 0
                for tok in row[:ai]:
                    if self._slots[i] is not owner:
                        break
                    appended += self._emit(i, tok, eos)
                    taken += 1
                emitted += taken
                overshoot += ai - taken
            sp.rounds += 1
            sp.row_rounds += live
            total_acc += acc
            # Verify positions the round threw away: k + 1 a live row.
            rejected += live * (k_used + 1) - acc
            if live:
                sp.controller.observe(acc / live, k_used)
        sp.accepted += total_acc
        if self._attrib is not None:
            self._attrib.token_event("useful", appended)
            self._attrib.token_event("overshoot", overshoot)
            self._attrib.token_event("spec_rejected", rejected)
        if self._obs is not None:
            self._obs.count("spec.rounds", len(rounds))
            self._obs.count("spec.accepted", total_acc)
        return emitted, t_arrival

    def _governor_feed(self, mode: Optional[str], emitted: int, dt: float) -> None:
        """A pure arrival of a speculative pool's dispatch in the mode its
        governor probes feeds the A/B; the first arrival after each switch
        is dropped (a cold mode's first dispatch)."""
        sp = self._spec
        if (sp is None or mode is None or not emitted
                or sp.governor.state not in ("spec_probe", "plain_probe")
                or mode != sp.governor.mode):
            return
        if sp.skip_feed:
            sp.skip_feed = False
        elif sp.governor.feed(emitted, dt):
            sp.skip_feed = True
        if sp.governor.disabled_spec and sp.disables == 0:
            sp.disables = 1
            if self._obs is not None:
                self._obs.instant("spec_governor_disable", tid="batcher",
                                  ema=round(sp.controller.ema, 3))

    def _fetch_worker(self) -> None:
        """Fetch side of the dispatch pipeline: waits on each chunk's copy,
        emits, retires finished and cancelled streams, and keeps the
        decode-phase clock."""
        eos = self.engine.tokenizer.eos_id
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            fetch, owners, firsts, pure, t_dispatch, walls, mode = item
            if self._worker_exc is not None:  # lint-ok: GS01 own-write read
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
                if mode == "spec":
                    emitted, t_arrival = self._fetch_spec(fetch, owners, firsts, eos)
                else:
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
                    rec.complete("fetch", t0_obs, tid="batcher", tokens=emitted, pure=pure,
                                 firsts=len(firsts))
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
                    self._governor_feed(mode, emitted, t_arrival - ref)
                self._prev_arrival = t_arrival
                self._beat = t_arrival  # a fetch arrival is progress
                self._unfetched -= 1
                if self._unfetched == 0:
                    # Drained: the next interval spans device idle time.
                    self._prev_arrival = None
                    if (self._attrib is not None and not self._dispatching
                            and (self._live() or self._queue
                                 or self._pending_wave is not None)):
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
        sanitizer.assert_held(self._work)
        seen, quiet = -1, 0
        while not self._closed and quiet < quiet_windows and time.monotonic() < deadline:
            n = len(self._queue)  # lint-ok: GS01 caller holds _work (asserted above)
            quiet = quiet + 1 if n == seen else 0
            seen = n
            self._work.wait(timeout=0.01)
        self._stat_add_locked(absorb_s=time.monotonic() - t_abs)
        self._gap_phase = "absorb"

    def _plan_prefix(self, candidates: list, pool_idle: bool) -> int:
        """The wave's shared-prefix length (all or nothing): join the
        established prefix when every candidate extends it; on an idle
        pool, establish the wave's own common prefix when at least two
        candidates share ``pool_prefix_min`` tokens, or (the radix consult)
        the engine's KV pool holds at least that much of the first
        candidate's prefix, at the resident length, so establishing it is a
        gather, not a prefill; else 0 (and an idle pool drops the prefix,
        back to the plain decode)."""
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
        est_p = p if p >= self._prefix_min and len(candidates) > 1 else 0
        kvp = self.engine._kv_pool
        if not est_p and kvp is not None and p >= self._prefix_min:
            # Radix consult: a wave with no sharing inside it (a lone
            # candidate is the common case) still establishes when the pool
            # holds its prefix; its rows then admit as suffixes.
            hit = kvp.match_len(list(candidates[0][:p]))
            if hit >= self._prefix_min:
                est_p = hit
        if not est_p:
            self._clear_prefix()
            return 0
        p = est_p
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

    def _fits(self, n: int, pos: int, wave_p: int, width: int = 0) -> bool:
        """A row of window ``n`` fits next to the frontier ``pos``: it ends
        at it and the splice width (``width``, else its own) stays in the
        cache."""
        eng = self.engine
        if not width:
            width = (_bucket(n, eng.max_seq) if wave_p
                     else max(_bucket(n, eng.max_seq), eng._rows_bucket(n)))
        return n <= pos and (pos - n) + width <= eng.max_seq

    def _wave_width(self, longest: int, wave_p: int) -> int:
        """The one width a wave splices at, ``longest`` its longest window."""
        eng = self.engine
        return _bucket(longest, eng.max_seq) if wave_p else eng._rows_bucket(longest)

    def _head_frontier(self, candidates: list, wave_p: int) -> int:
        """An idle pool's frontier planned from the queue's head: the
        longest leading run of candidates (at most ``max_batch``) whose rows
        all fit one splice at the run's longest window, the head alone at
        worst, which always fits. (A departure from the JAX batcher, which
        keeps the frontier that admits nothing.)"""
        for k in range(min(self.max_batch, len(candidates)), 1, -1):
            ns = [len(ids) - wave_p for ids in candidates[:k]]
            pos = max(ns)
            width = self._wave_width(pos, wave_p)
            if all(self._fits(n, pos, wave_p) and self._fits(n, pos, wave_p, width)
                   for n in ns):
                return pos
        return len(candidates[0]) - wave_p

    def _admission_pass(self, pending: list, firsts: list) -> list:
        """Admit what fits from ``pending``, in waves, until nothing more
        can be admitted; returns the requeue list (priority order, FIFO
        within a class). A wave on a decoding pool with ``prefill_budget``
        set opens an interleaved session instead and ends the pass."""
        eng = self.engine
        requeue: list = []
        while True:
            # Priority order, stable: a higher class drained in the same
            # pass takes slots first, FIFO holds within a class.
            pending.sort(key=lambda item: item[1].priority)
            if self._rows_bucket_enabled and self._rows_cap < self.max_batch:
                # Admission-driven regrowth, before the wave splices.
                demand = sum(1 for s in self._slots if s is not None) + sum(
                    1 for _, s in pending if not s.ctx.done() and s.max_new > 0)
                target = self._rows_target(demand)
                if target > self._rows_cap:
                    self._resize_drained(target)
            free = [i for i in range(self._rows_cap) if self._slots[i] is None]
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
                if not self._fits(len(candidates[0]) - wave_p, self._pos, wave_p):
                    # The head cannot sit next to that frontier, and no row
                    # leapfrogs it, so the pass would admit nothing, again
                    # and again: re-plan from the queue's head.
                    self._pos = self._head_frontier(candidates, wave_p)
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
                if not self._fits(n, self._pos, wave_p):
                    requeue.append((ids, stream))
                    continue
                if batch:
                    # The wave splices at one width: every member must fit it.
                    members = [len(i2) - wave_p for _, i2, _ in batch] + [n]
                    w_new = self._wave_width(max(members), wave_p)
                    if not all(self._fits(nj, self._pos, wave_p, w_new) for nj in members):
                        requeue.append((ids, stream))
                        continue
                batch.append((free.pop(0), ids, stream))
            pending = []
            singles: list = []
            if batch and self._one_by_one:
                # An sp mesh keeps each row's ring prefill (a batched
                # admission is a plain left-aligned prefill).
                singles = batch
            elif (batch and self._prefill_budget > 0 and self._pending_wave is None
                    and self._live() and self._begin_wave(batch, wave_p)):
                # Interleaved: the wave fills between decode chunks; later
                # arrivals queue until it installs. An idle pool admits
                # classically (there is no decode to overlap).
                return requeue
            elif batch:
                self._nondecode_work = True
                t_adm = self._admission_starts()
                t0_obs = self._obs.now() if self._obs is not None else 0
                admitted = None
                try:
                    with self._wall("prefill"), obs.attrib.tag("prefill"):
                        admitted = self._admit_batch(batch, wave_p)
                finally:
                    ok = admitted is not None and admitted is not _STALE_PREFIX
                    self._stat_add(
                        admit_s=time.monotonic() - t_adm, admitted=len(batch) if ok else 0,
                        admit_tokens=sum(len(i2) - wave_p for _, i2, _ in batch) if ok else 0)
                    if self._obs is not None:
                        self._obs.complete("admit", t0_obs, tid="batcher", streams=len(batch),
                                           prefix=wave_p, ok=ok,
                                           resumed=sum(st.preempted for _, _, st in batch))
                if admitted is _STALE_PREFIX:
                    # Back to the queue's head; the next pass plans the
                    # wave on the new weights.
                    return [(ids, st) for _, ids, st in batch] + requeue
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
                if not self._fits(n, self._pos, 0, _bucket(n, eng.max_seq)):
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
                    if stream.jentry is not None:
                        # Terminal on a healthy pool: not a replay candidate.
                        stream.jentry.close("failed")
                finally:
                    ok = entry is not None
                    self._stat_add(admit_s=time.monotonic() - t_adm, admitted=int(ok),
                                   admit_tokens=len(ids) if ok else 0)
                    if self._obs is not None:
                        self._obs.complete("admit", t0_obs, tid="batcher", streams=1,
                                           prefix=0, ok=ok, resumed=int(stream.preempted))
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

    def _drain_queue_locked(self) -> list:
        """Under ``self._work``: take everything still queued so shutdown
        can cancel it (no future may hang forever)."""
        sanitizer.assert_held(self._work)
        queued = list(self._queue)
        self._queue.clear()
        return queued

    def _loop(self) -> None:
        eng = self.engine
        chunk = eng.stream_interval
        # First tokens of waves admitted since the last dispatch: they ride
        # down with the next chunk's fetch.
        pending_firsts: list[tuple] = []
        while True:
            # Schedule-exploration seam (analysis/schedule.py): one
            # iteration of the scheduler loop is the protocol step the
            # model checker preempts between.
            sanitizer.sched_point("batcher.schedule")
            with self._work:
                while (
                    self._worker_exc is None
                    and not self._queue
                    and not self._live()
                    and self._pending_wave is None
                    and not (self._closed and self._unfetched == 0)
                ):
                    self._work.wait()
                if self._worker_exc is not None:
                    raise self._worker_exc
                if (self._closed and not self._live() and self._unfetched == 0
                        and self._pending_wave is None):
                    for _, s in self._drain_queue_locked():
                        s.future.cancel()
                    return
                pending = []
                if self._pending_wave is None:
                    # While a wave fills, submissions stay queued (waves
                    # never overlap); their arrival still breaks the gates.
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
            if self._prefix_cache is not None and (
                self._prefix_weight_version != eng.weight_version
            ):
                # A swap landed since the prefix was established: its KV is
                # the old weights'. Flips happen with no pins, so no row
                # attends it: clear, and the next wave re-establishes.
                self._clear_prefix()
            if pending and eng.swap_pending():
                # Weight-swap admission gate: admitting now would re-pin the
                # old weights and starve the parked flip; queued work holds
                # at the head while resident streams decode and retire.
                with self._work:
                    self._queue[:0] = pending
                    pending = []
                    if not self._live():
                        # The flip waits on pins held elsewhere: a bounded
                        # wait, not a hot spin.
                        self._work.wait(timeout=0.01)
            self._admitting = pending
            requeue = self._admission_pass(pending, pending_firsts) if pending else []
            self._admitting = []
            resumed: list = []
            # A racy pre-check: _plan_preempt drains the nudge under the lock.
            if self._preempt_enabled and (
                requeue or self._preempt_req  # lint-ok: GS01 racy pre-check
            ):
                # Blocked higher-class work against lower-class residents:
                # the resumed entries queue behind the blocked work, so the
                # next pass seats the higher class in the freed slots.
                resumed = self._plan_preempt(requeue, pending_firsts)
            with self._work:
                self._queue[:0] = requeue + resumed
                qlen0 = len(self._queue)
            if resumed:
                continue  # admit the unblocked work now
            if self._pending_wave is not None:
                # One credit of the filling wave between the previous decode
                # chunk and the next; with nothing live to overlap, all of it.
                self._advance_wave(pending_firsts, exhaust=not self._live())
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
                self._unfetched > 0  # lint-ok: GS01 monotone read
                or len(self._queue) > qlen0  # lint-ok: GS01 racy pre-check
            ):
                continue
            if self._rows_bucket_enabled and not pending_firsts and self._pending_wave is None:
                # Never with first tokens pending (their slot indices are not
                # remapped by a move) nor while a wave holds reserved slots.
                self._maybe_shrink()
            faults = eng._faults
            if faults is not None:
                faults.check("decode")  # injected device loss
                # The engine site (recovery/): ``crash`` kills the whole pool
                # mid-decode (pool-fatal: it escapes to _run's fatal exit,
                # the supervisor's restart-and-replay trigger); ``wedge``
                # stalls the scheduler without cooperating, freezing the
                # heartbeat the watchdog reads.
                fs = faults.fire("engine", model=eng.cfg.name)
                if fs is not None and fs.kind == "crash":
                    raise InjectedFault(f"injected engine crash mid-decode ({eng.cfg.name})")
                if fs is not None and fs.kind == "wedge":
                    time.sleep(float(fs.param("s", 600.0)))
                    if self.failed_exc is not None:
                        continue  # abandoned meanwhile: dispatch nothing more
                if eng.weight_version > 0:
                    # canary_regress slows decode only on swapped-in weights.
                    fs = faults.fire("swap", phase="decode", model=eng.cfg.name,
                                     version=eng.weight_version)
                    if fs is not None and fs.kind == "canary_regress":
                        time.sleep(float(fs.param("s", 0.05)))
            self._dispatch(chunk, live_now[0].sampling, pending_firsts)
            pending_firsts = []

    def _dispatch(self, chunk: int, sampling: SamplingParams, firsts: list) -> None:
        """Enqueue one decode chunk over every row (a round group on a greedy
        speculative pool) and hand its token copy (with the pending first
        tokens) to the fetch worker."""
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
        mode = None
        if self._spec is not None and sampling.temperature == 0.0:
            # A spec pool's greedy dispatch: a round group, or a bitmap-keeping
            # plain window (governor, brownout, cache tail). A sampled
            # template keeps the classic chunk below.
            with obs.attrib.tag("spec_verify"):
                toks, covered, mode = self._dispatch_spec(chunk)
            fetch = _Fetch(toks, wall)
        else:
            covered = self._plan_steps(chunk)
            fetch = self._dispatch_chunk(covered, sampling, wall)
        for rec in (self._obs, self._bb):
            if rec is not None:
                args = {"spec": mode} if mode is not None else {}
                rec.complete("decode", t0_obs, tid="batcher", steps=covered, pos=self._pos,
                             **args)
        walls, self._walls = self._walls, []
        if wall is not None:
            walls.append(("spec_verify" if mode == "spec" else "decode", fetch.wall))
        # A pure interval: nothing but the previous chunk ran on the device
        # since the last dispatch (no admission, no compaction).
        pure = not firsts and not self._nondecode_work
        self._nondecode_work = False
        for s in self._slots:
            if s is not None:
                # The guaranteed advance: a spec round gives every row at
                # least one token.
                s.planned += covered
        # The owners of the chunk's columns: the current row capacity.
        item = (fetch, self._slots[:self._rows_cap], firsts, pure, t_dispatch, walls, mode)
        self._beat = time.monotonic()  # a dispatch is progress
        with self._work:
            self._unfetched += 1
            self._dispatching = False
        self._fetch_q.put(item)

    def _dispatch_chunk(self, n_steps: int, sampling: SamplingParams,
                        wall: Optional[DeviceWall]) -> _Fetch:
        """The classic chunk: ``n_steps`` decode steps over every row."""
        eng = self.engine
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
            kv_valid = sum(max(0, self._pos - r + 1)
                           for r in self._row_start_host[:self._rows_cap])
        sentinel = self._integrity is not None
        poison = None
        if sentinel and eng._faults is not None:
            # nan_logits@row=N (site ``corrupt``): poison one row's logits,
            # only meaningful with the sentinel on.
            fs = eng._faults.fire("corrupt", surface="logits", model=eng.cfg.name)
            if fs is not None and fs.kind == "nan_logits":
                poison = int(fs.param("row", 0))
        verdict = None
        with obs.attrib.tag("decode"):
            out = eng._decode_chunk(
                self._token, pos, self._cache, n_steps, self._gen,
                (sampling.temperature, sampling.top_k, sampling.top_p),
                eng._decode_width(self._pos + n_steps), kv_valid=kv_valid,
                sentinel=sentinel, poison_row=poison, **rows,
            )
        if sentinel:
            self._token, toks, _, verdict = out
        else:
            self._token, toks, _ = out
        self._pos += n_steps
        return _Fetch(toks, wall, verdict)

    def _dispatch_spec(self, chunk: int) -> tuple:
        """One speculative round group, or one bitmap-keeping plain window
        while the governor probes or locks plain, under brownout, or when
        no round fits the cache. Returns ``(tokens, guaranteed per-stream
        advance, mode)``: a round group's tokens are [R, B, k + 2] (each
        row's ``k + 1`` candidates, then its acceptance), a plain window's
        [n, B]."""
        eng = self.engine
        sp = self._spec
        k = sp.controller.k
        if sp.governor.mode == "plain" or self._brownout or self._pos + (k + 1) > eng.max_seq:
            n_steps = self._plan_steps(chunk)
            width = eng._decode_width(min(self._pos + n_steps, eng.max_seq))
            self._token, toks, sp.blen = _plain_chunk_masked(
                eng, self._token, self._pos, self._row_start, sp.blen, self._cache, sp.valid,
                sp.buf, n_steps, width)
            self._pos += n_steps
            return toks, n_steps, "plain"
        rounds = max(1, chunk // (k + 1))
        need = max((s.max_new - s.planned for s in self._slots if s is not None), default=0)
        if 0 < need < rounds:
            rounds = need  # a round advances every stream >= 1 token
        while rounds > 1 and self._pos + rounds * (k + 1) > eng.max_seq:
            rounds -= 1
        width = eng._decode_width(min(self._pos + rounds * (k + 1), eng.max_seq))
        vocab = eng.cfg.vocab_size
        outs = []
        for _ in range(rounds):
            fault = None
            if eng._faults is not None:
                fs = eng._faults.fire("spec", model=eng.cfg.name)
                if fs is not None and fs.kind == "draft_stall":
                    time.sleep(float(fs.param("s", 0.05)))  # the round cadence collapses
                elif fs is not None and fs.kind == "acceptance_collapse":
                    sp.collapse_faults += 1
                    fault = "acceptance_collapse"
            with obs.attrib.tag("draft"):
                if fault is not None:
                    drafts = _junk_propose(sp.buf, sp.blen, k, vocab)
                elif sp.cfg.kind == "oracle":
                    drafts = _oracle_propose(sp.obuf, sp.blen, k, vocab, sp.cfg.oracle_accept)
                else:
                    cap = eng._capture("draft", (tuple(sp.buf.shape[:1]), k, sp.cfg.ngram), k)
                    with cap or nullcontext():
                        drafts = _lookup_propose(sp.buf, sp.blen, k, sp.cfg.ngram)
            out, a, self._token, self._row_start, sp.blen = _spec_verify_batch(
                eng, self._token, drafts, self._pos, self._row_start, sp.blen, self._cache,
                sp.valid, sp.buf, k, width)
            self._pos += k + 1
            outs.append(torch.cat([out, a[:, None]], dim=1))
        return torch.stack(outs), rounds, "spec"
