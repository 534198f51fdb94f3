"""Disaggregated prefill → decode: a dedicated prefill worker hands finished
prompt KV to the decode engine's paged KV pool (port of
``llm_consensus_tpu/engine/handoff.py``).

The worker drains a bounded, priority-ordered queue of prompts in waves,
runs the engine's admission-prefill chunk programs to completion for each
wave (``Engine.admission_session``: one-shot flash for a bucket within the
prefill chunk, the plain op in chunks past it), and publishes each row's
whole-block prefix into the DECODE engine's :class:`~llm_consensus_tpu_torch.
kv.pool.KVPool` with ``source="handoff"``. The decode side's admission then
finds the blocks through its ordinary radix paths (the batcher's consult,
a wave's fork, a single-stream restore) exactly as if a local request had
retained them, and only prefills the suffix past them.

What the port does differently from the JAX module, and why:

  * **One card, two roles.** The JAX worker runs on a disjoint device
    sub-mesh and reshards each row onto the decode mesh. On one H100 both
    roles share the device (``parallel/mesh.py`` ``split_roles``, the
    port's departure); the worker runs each wave on a ``torch.cuda.Stream``
    of its own, so the wave's kernels can run beside the decode loop's,
    which stay on the device's default stream. On a provider of several
    devices the roles are placed apart (the provider's ``prepare``): the
    wave runs on a copy of the decode tree on the prefill device (one per
    weight version) and each row's span is copied to the decode device
    before its publish.
  * **Ordering and lifetimes across the two streams.** The wave ends with
    an event recorded on the worker's stream; the decode stream waits on
    it before the publish's copies are enqueued there, so no gather the
    decode side enqueues later can read a block before it is written. The
    wave cache was allocated on the worker's stream and is read by the
    publish on the decode stream, so each of its leaves is marked with
    ``record_stream``: the caching allocator cannot hand its memory to the
    next wave before those copies have run. The worker waits for its own
    event before it publishes (the JAX worker's ``block_until_ready``), so
    a wave's wall is the prefill role's compute.
  * **One weight version.** A wave pins the decode engine's weights (the
    batcher's pin discipline) for its whole span and runs on the tree of
    exactly the pinned version, so a weight swap flips only after the
    wave's publish, and the flip's cache hygiene (``Engine._post_flip``
    evicts every cold block) drops what the wave published: no KV of
    replaced weights outlives the flip. Where both roles are one
    unsharded engine's device, the prefill engine holds no tree and runs on
    the decode engine's (no second copy). Otherwise it runs on a tree of
    its own in its own layout (its mesh's shards): the one it was built
    with, for the decode version the caller names (the provider copies it
    under a pin of the decode weights, so no swap lands between the copy
    and its tag), and for any other version a copy of the decode engine's
    weights, joined from its shards and cut to the prefill mesh, made once
    per version. The JAX prefill engine keeps its own tree, which a swap of
    the decode engine does not touch.
  * **Only prompts the decode side reuses.** The decode side reuses a pool
    match only from one prefill chunk on (a single-stream restore; a
    batcher wave establishes from the pool only when it is idle). With
    both roles on one device a shorter prompt's handoff buys no overlap
    worth its second prefill on the same SMs, so ``submit`` takes it
    classically (``min_tokens``); the JAX worker, on chips of its own,
    hands off every prompt of one block.
  * **The reshard by heads.** ``_extract_row_span`` is a slice of each
    leaf along its sequence axis (``ops/quant.py`` ``kv_seq_axis``). When
    the two roles' cache layouts differ (a sharded role, or another
    device), the span is joined from the prefill role's head slices and cut
    into the decode mesh's (``ShardGroup.join_cache`` / ``split_cache``),
    each piece copied onto its shard's device: the bytes JAX's
    ``device_put`` across meshes moves, also between a tp that divides
    the heads and one that does not. Otherwise the publish's indexed copy
    is the transfer.

Kept from the JAX module: the bounded queue (``submit`` rejects at
``depth`` and the caller admits classically at once), the priority order
(stable within a class), the per-wave fallback (any failure inside a wave,
an injected ``prefill_worker_crash`` included, fails only that wave's
tickets; their submitters take the classic path, which runs the same
kernels), the ``disagg`` fault site (``handoff_stall``,
``prefill_worker_crash``), the digest check of every handed-off block
(integrity surface ``handoff``, ``bit_flip@surface=handoff``; the digest
is of the whole span, every shard's heads joined, on both sides), the
``handoff_staging:<model>`` HBM component while a row is staged, the
``kv_handoff`` attribution family and its transfer bytes in the roofline
ledger, and the stats keys. Locks are plain ``threading`` locks.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Optional

import torch

from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.kv.pool import _leaves
from llm_consensus_tpu_torch.models.transformer import ShardGroup, cache_map, is_shard_list
from llm_consensus_tpu_torch.obs.attrib import tag as _attrib_tag
from llm_consensus_tpu_torch.ops.quant import kv_seq_axis

DEFAULT_DEPTH = 8
DEFAULT_WAVE_ROWS = 4
DEFAULT_WAIT_S = 30.0


def _extract_row_span(pcache: dict, row: int, span: int) -> dict:
    """Row ``row`` of a ``[k, width]`` admission-prefill cache, cut to its
    first ``span`` sequence slots: a view of each leaf (batch axis 1)."""
    return cache_map(lambda leaf: leaf.narrow(1, row, 1).narrow(kv_seq_axis(leaf), 0, span),
                     pcache)


def _to(cache: dict, device: torch.device) -> dict:
    """A cache's leaves copied to ``device``."""
    return cache_map(lambda leaf: leaf.to(device), cache)


def _whole(cache) -> dict:
    """A cache in one piece: a sharded layout's head slices joined on its
    first shard's device (a copy), a whole cache as it is."""
    if is_shard_list(cache):
        return ShardGroup.join_cache(cache, next(_leaves(cache)).device)
    return cache


class HandoffTicket:
    """One prompt's pending handoff: resolved by the worker wave."""

    __slots__ = ("ids", "priority", "seq", "ok", "truncated", "error", "_done")

    def __init__(self, ids: list, priority: int, seq: int):
        self.ids = ids
        self.priority = priority
        self.seq = seq
        self.ok = False
        self.truncated = False
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def resolve(self, ok: bool, truncated: bool = False,
                error: Optional[BaseException] = None) -> None:
        self.ok = ok
        self.truncated = truncated
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float]) -> bool:
        return self._done.wait(timeout)


class KVHandoff:
    """Dedicated prefill worker and KV handoff for ONE preset.

    Owns the prefill-only engine (no decode loop, no batcher) and a
    bounded priority queue of :class:`HandoffTicket`; a daemon worker
    drains the queue in waves of at most ``wave_rows`` prompts and
    publishes each row's whole-block prefix into the decode engine's KV
    pool. ``version`` is the decode weight version the prefill engine's
    own tree was copied from, if it holds one (the provider copies it under
    a pin of the decode weights); ``depth`` bounds the queue, ``wait_s`` a
    submitter's wait (the
    JAX knobs' defaults; the provider passes ``LLMC_DISAGG_DEPTH``,
    ``_WAVE`` and ``_WAIT_S``). Thread-safe; built by
    ``GPUProvider._handoff_for``.
    """

    def __init__(self, prefill_engine, decode_engine, *, version: Optional[int] = None,
                 depth: int = DEFAULT_DEPTH, wave_rows: int = DEFAULT_WAVE_ROWS,
                 wait_s: float = DEFAULT_WAIT_S, name: str = ""):
        pool = getattr(decode_engine, "_kv_pool", None)
        if pool is None:
            raise ValueError("KVHandoff requires the decode engine's paged KV pool "
                             "(kv_pool=True): the pool arena is the handoff channel")
        self._pe = prefill_engine
        self._de = decode_engine
        self._pool = pool
        # The shortest prompt worth a handoff. On one device the two roles
        # share the SMs, and the decode side reuses a pool match only from
        # one prefill chunk on: a shorter prompt would be prefilled twice.
        self.min_tokens = pool.block_size
        if prefill_engine.device == decode_engine.device:
            self.min_tokens = max(self.min_tokens, decode_engine.prefill_chunk or 0)
        self.depth = max(1, int(depth))
        self.wave_rows = max(1, int(wave_rows))
        self._wait_s = float(wait_s)
        self._name = name or prefill_engine.cfg.name
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: list[HandoffTicket] = []  # guarded by _lock
        self._seq = 0
        self._closed = False
        self.waves = 0
        # Lifetime counters (the JAX keys): handoff_* the transfer,
        # prefill_* the prefill role's compute (the per-role utilization
        # gauge's numerator), covered the prompts already pool-resident.
        self.stats = {
            "submitted": 0, "covered": 0, "rejected": 0, "timeouts": 0,
            "fallbacks": 0, "completed": 0, "truncated": 0,
            "handoff_tokens": 0, "handoff_bytes": 0, "handoff_s": 0.0,
            "prefill_tokens": 0, "prefill_s": 0.0, "overlap_polls": 0,
            "overlap_abandons": 0,
        }
        # Planes bound once (a disabled plane costs a None check a wave).
        self._faults = faults.plan()
        self._obs = obs.recorder()
        self._attrib = obs.attrib.ledger()
        # Every handed-off block is verified, not sampled: a mismatch fails
        # only that row's ticket and its submitter prefills classically.
        self._integrity = integrity.plane()
        # (version, weights in the prefill engine's form): the tree a wave of
        # that decode version runs on, when the roles do not share one. The
        # prefill engine's own tree counts as ``version`` only when the
        # caller names the decode version it was copied from (under a pin);
        # otherwise the first wave copies the decode engine's tree.
        own = prefill_engine._resident()
        self._tree: Optional[tuple] = (
            (int(version), own) if own is not None and version is not None else None)
        dev = decode_engine.device
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
            self._decode_stream = torch.cuda.default_stream(dev)
        else:
            self._stream = self._decode_stream = None
        self._thread = threading.Thread(target=self._run, name=f"llmc-handoff-{self._name}",
                                        daemon=True)
        self._thread.start()

    # -- submit side -------------------------------------------------------------

    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def saturation(self) -> float:
        """Queue fullness in [0, 1]: the admission backpressure signal the
        gateway's ``load_score`` and the pressure snapshot read."""
        with self._lock:
            return min(1.0, len(self._queue) / max(1, self.depth))

    def submit(self, prompt_ids: list, priority: int = 1) -> Optional[HandoffTicket]:
        """Queue one prompt for the prefill role; None when the prompt is
        shorter than ``min_tokens`` (one block; on a shared device one
        prefill chunk) or the bounded queue is full (the caller admits
        classically now)."""
        ids = list(prompt_ids)
        if len(ids) < self.min_tokens:
            return None
        with self._lock:
            self.stats["submitted"] += 1
            if self._closed or len(self._queue) >= self.depth:
                self.stats["rejected"] += 1
                return None
            self._seq += 1
            t = HandoffTicket(ids, int(priority), self._seq)
            if self._pool.covers(ids):
                # Already resident (repeat traffic, a prior wave).
                self.stats["covered"] += 1
                t.resolve(True)
                return t
            self._queue.append(t)
            self._work.notify()
        return t

    def _timeout(self, ctx) -> float:
        timeout = self._wait_s
        if ctx is not None:
            rem = ctx.remaining()
            if rem is not None:
                timeout = min(timeout, max(0.0, rem))
        return timeout

    def run(self, prompt_ids: list, priority: int = 1, ctx=None) -> tuple[bool, bool]:
        """Submit and wait (bounded by ``wait_s`` and the request's
        deadline): ``(handed_off, truncated)``. A reject, a timeout or a
        failed wave returns ``(False, False)``: the caller takes the
        classic path."""
        t = self.submit(prompt_ids, priority)
        if t is None:
            return False, False
        if not t.wait(self._timeout(ctx)):
            with self._lock:
                self.stats["timeouts"] += 1
            return False, False
        return t.ok, t.truncated

    def run_overlapped(self, prompt_ids: list, priority: int = 1, ctx=None,
                       poll_s: float = 0.05) -> tuple[bool, bool]:
        """:meth:`run` with a polled wait (``LLMC_DISAGG_OVERLAP``, the
        default): between slices of ``poll_s`` the submitter checks its
        request's context, so a cancelled request abandons its ticket
        within one slice. An abandoned wave still publishes (it warms the
        pool for the next request)."""
        t = self.submit(prompt_ids, priority)
        if t is None:
            return False, False
        deadline = time.monotonic() + self._timeout(ctx)
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                with self._lock:
                    self.stats["timeouts"] += 1
                return False, False
            if t.wait(min(poll_s, left)):
                return t.ok, t.truncated
            with self._lock:
                self.stats["overlap_polls"] += 1
            if ctx is not None and ctx.done():
                with self._lock:
                    self.stats["overlap_abandons"] += 1
                return False, False

    def close(self) -> None:
        """Stop the worker and fail the queued tickets (their submitters
        fall back). The daemon thread is never joined: it may be mid-wave."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            queued, self._queue = self._queue, []
            self._work.notify_all()
        for t in queued:
            t.resolve(False, error=RuntimeError("handoff closed"))

    # -- worker side -------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._work:
                while not self._queue and not self._closed:
                    self._work.wait()
                if self._closed:
                    return
                # Priority order, stable within a class (the admission order).
                self._queue.sort(key=lambda t: (t.priority, t.seq))
                batch = self._queue[:self.wave_rows]
                del self._queue[:len(batch)]
                self.waves += 1
                wave_n = self.waves
            try:
                if self._faults is not None:
                    fs = self._faults.fire("disagg", wave=wave_n, model=self._pe.cfg.name)
                    if fs is not None:
                        if fs.kind == "handoff_stall":
                            time.sleep(float(fs.param("s", 0.2)))
                        elif fs.kind == "prefill_worker_crash":
                            raise faults.InjectedFault(
                                f"injected prefill worker crash at wave {wave_n} "
                                f"({self._pe.cfg.name})")
                with torch.inference_mode():
                    self._wave(batch, wave_n)
            except BaseException as exc:  # noqa: BLE001 — per-wave fallback
                with self._lock:
                    self.stats["fallbacks"] += len(batch)
                if self._obs is not None:
                    self._obs.instant("handoff_fallback", tid="handoff", wave=wave_n,
                                      streams=len(batch), error=repr(exc)[:200])
                for t in batch:
                    if not t._done.is_set():
                        t.resolve(False, error=exc)

    def _wave(self, batch: list, wave_n: int) -> None:
        """One wave on the decode engine's pinned weights: admission-prefill
        the batch on the worker's stream, then per row take the whole-block
        span, check its digests and publish it into the pool."""
        pe, de = self._pe, self._de
        bs = self._pool.block_size
        t0_obs = self._obs.now() if self._obs is not None else 0
        rows = [list(t.ids) for t in batch]
        version = de.pin_weights()
        try:
            # The pin holds the flip off, so this is the tree of ``version``.
            pe._install(self._role_tree(version))
            t_pf = time.monotonic()
            stream = self._stream
            with _attrib_tag("prefill"), (torch.cuda.stream(stream) if stream is not None
                                          else nullcontext()):
                _last_logits, pcache, width = pe.admission_session(rows).run()
                done = torch.cuda.Event() if stream is not None else None
                if done is not None:
                    done.record(stream)
            if done is not None:
                done.synchronize()  # the wave's wall is the prefill role's
            self._decode_place(pcache, done)
            prefill_s = time.monotonic() - t_pf
            with self._lock:
                self.stats["prefill_tokens"] += sum(len(r) for r in rows)
                self.stats["prefill_s"] += prefill_s
            for i, t in enumerate(batch):
                self._hand_off(t, i, pcache, wave_n, version)
        finally:
            # Between waves the prefill role holds only a tree of its own.
            pe._install(self._tree[1] if self._tree is not None else None)
            de.unpin_weights()
        if self._obs is not None:
            self._obs.complete("handoff_wave", t0_obs, tid="handoff", wave=wave_n,
                               streams=len(batch), width=width)
            self._obs.count("handoff.tokens", sum((len(t.ids) // bs) * bs for t in batch))

    def _role_tree(self, version: int):
        """The weights a wave of decode version ``version`` runs on, in the
        prefill engine's form: its own tree of that version; else the decode
        engine's tree itself when both are one unsharded engine's device;
        else the decode engine's whole tree (joined from its shards) placed
        on the prefill device and cut to the prefill mesh, made once per
        weight version (the JAX prefill engine holds its own tree on its
        slice)."""
        pe, de = self._pe, self._de
        if self._tree is not None and self._tree[0] == version:
            return self._tree[1]
        if pe.device == de.device and not pe.sharded and not de.sharded:
            return de.params

        def place(tree):
            return {k: place(v) if isinstance(v, dict) else v.to(pe.device)
                    for k, v in tree.items()}

        whole = place(de.full_params())
        self._tree = (version, pe._shard(whole) if pe.sharded else whole)
        return self._tree[1]

    def _reshard(self, span: dict):
        """A row's span (the prefill engine's cache layout) in the decode
        engine's: joined from the prefill mesh's head slices and cut into
        the decode mesh's, each on its shard's device (the bytes unchanged);
        the span itself when both roles hold one cache on one device."""
        pe, de = self._pe, self._de
        if not pe.sharded and not de.sharded:
            return span if pe.device == de.device else _to(span, de.device)
        whole = _whole(span)
        return de._groups[0].split_cache(whole) if de.sharded else _to(whole, de.device)

    def _hand_off(self, t: HandoffTicket, row: int, pcache: dict, wave_n: int,
                  version: int) -> None:
        """Publish one row's whole-block span; resolves its ticket."""
        bs = self._pool.block_size
        nblk = len(t.ids) // bs
        if nblk < 1:
            t.resolve(False)
            return
        span = nblk * bs
        t_x = time.monotonic()
        staging = f"handoff_staging:{self._de.cfg.name}"
        nbytes = 0
        try:
            with _attrib_tag("kv_handoff"):
                # The handoff proper: the span crosses to the decode layout.
                staged = self._reshard(_extract_row_span(pcache, row, span))
                nbytes = sum(leaf.numel() * leaf.element_size() for leaf in _leaves(staged))
                if self._attrib is not None:
                    # The staged span is resident until the publish's copy
                    # consumes it: the watermark sees it.
                    self._attrib.update_component(staging, nbytes)
                    self._attrib.observe_device("kv_handoff", time.monotonic() - t_x)
                rl = obs.roofline.ledger()
                if rl is not None:
                    rl.note_transfer("kv_handoff", nbytes)
                if self._integrity is not None:
                    self._verify(staged, pcache, row, span, wave_n)
                if self._de.weight_version != version:
                    # Unreachable under the wave's pin; a publish of KV from
                    # replaced weights is dropped, never made.
                    raise RuntimeError("weights flipped during the handoff wave")
                wrote, truncated = self._pool.publish(t.ids[:span], staged, source="handoff")
        except BaseException as exc:  # noqa: BLE001 — per-row fallback
            with self._lock:
                self.stats["fallbacks"] += 1
            t.resolve(False, error=exc)
            return
        finally:
            if self._attrib is not None:
                self._attrib.update_component(staging, 0)
        dt = time.monotonic() - t_x
        with self._lock:
            self.stats["completed"] += 1
            self.stats["handoff_tokens"] += span
            self.stats["handoff_bytes"] += nbytes
            self.stats["handoff_s"] += dt
            if truncated:
                self.stats["truncated"] += 1
        t.resolve(True, truncated=truncated)

    def _decode_place(self, pcache: dict, done) -> None:
        """Hand the wave cache to the decode role (the JAX module's reshard
        onto the decode mesh): the decode stream waits for the wave's event
        ``done`` before anything enqueued on it later (the publish's copies,
        then every gather), and each leaf is marked in use by that stream,
        so the caching allocator keeps its memory until those copies ran.
        On the CPU (no streams) there is nothing to order."""
        if done is None:
            return
        self._decode_stream.wait_event(done)
        for leaf in _leaves(pcache):
            leaf.record_stream(self._decode_stream)

    def _verify(self, staged: dict, pcache: dict, row: int, span: int, wave_n: int) -> None:
        """Digest every block of the row on both sides of the handoff: the
        wave cache the prefill role wrote and the staged span the publish
        reads (on one card the same memory, read back through the decode
        stream). ``bit_flip@surface=handoff`` corrupts the first block's
        staged read; a mismatch raises ``IntegrityError`` into the row's
        fallback, so corrupt blocks never enter the pool."""
        bs = self._pool.block_size
        flip = False
        if self._faults is not None:
            fs = self._faults.fire("corrupt", surface="handoff", wave=wave_n)
            flip = fs is not None and fs.kind == "bit_flip"
        source = _whole(_extract_row_span(pcache, row, span))
        staged = _whole(staged)
        for b_i in range(span // bs):
            self._integrity.check("handoff")
            want = self._pool.block_digest(source, b_i * bs)
            got = self._pool.block_digest(staged, b_i * bs, flip_bit=flip and b_i == 0)
            if want != got:
                self._integrity.failure("handoff", f"digest mismatch at block {b_i} "
                                                   f"(wave {wave_n})")
                raise integrity.IntegrityError("handoff", f"block {b_i} corrupted in transfer")

    # -- introspection -------------------------------------------------------------

    def snapshot(self) -> dict:
        """This preset's entry of the /statsz ``disagg`` block (the JAX
        keys; one device a role on one card)."""
        with self._lock:
            out = dict(self.stats)
            out["queued"] = len(self._queue)
            out["waves"] = self.waves
        out["depth"] = self.depth
        out["wave_rows"] = self.wave_rows
        out["prefill_devices"] = self._pe.mesh.size if self._pe.mesh is not None else 1
        out["decode_devices"] = self._de.mesh.size if self._de.mesh is not None else 1
        out["shared_device"] = self._pe.device == self._de.device
        out["min_tokens"] = self.min_tokens
        if out["handoff_s"] > 0:
            out["handoff_bytes_per_s"] = round(out["handoff_bytes"] / out["handoff_s"], 1)
        out["handoff_s"] = round(out["handoff_s"], 4)
        out["prefill_s"] = round(out["prefill_s"], 4)
        return out


__all__ = ["DEFAULT_DEPTH", "DEFAULT_WAIT_S", "DEFAULT_WAVE_ROWS", "HandoffTicket", "KVHandoff"]
