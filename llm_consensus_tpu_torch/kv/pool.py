"""Paged KV block pool: one preallocated arena and its block copies (port
of ``llm_consensus_tpu/kv/pool.py``).

The device half of the cross-request KV cache (see the package docstring):

  * **One arena per engine**, allocated once at construction with the
    engine's ``new_cache(1, n_blocks x block_size)``: every
    leaf keeps a working cache's layout, ``[L, 1, n_blocks * bs, Hkv, dh]``
    (bf16, or the int8 codes) and the int8 scales ``[L, 1, Hkv,
    n_blocks * bs]`` (sequence axis last, as the decode kernels read them).
    A sharded engine's arena is its cache layout: one such arena per
    attention position, of that shard's heads, every copy moving the same
    block ids in each.
  * **One indexed copy per leaf** serves each direction (:func:`_gather`,
    :func:`_scatter`): the sequence axis is viewed as ``[n_blocks, bs]``
    and the blocks move by ``index_select`` into the destination (gather:
    arena → a fresh ``[1, max_seq]`` cache, the radix-hit path) or by
    ``index_copy_`` into the arena (publish: a finished cache → arena). A
    1,501-token llama-3-8b prefix is 24 blocks over 4 leaves (int8: 8):
    4 copies, not 96. The JAX package pads the block count to a power of
    two only to bound XLA's programs; eager PyTorch has no programs, so
    nothing is padded.
  * **Bytes, not recompute**: blocks store exact cache bytes at absolute
    positions ``[0, n)`` of a left-aligned ``[1, S]`` cache, so a gathered
    prefix is bit-identical to what the snapshot restore would give and
    greedy decode is identical pool on and off.

Concurrency: one pool lock serializes radix walks, slot accounting and the
device DISPATCH of every copy (the enqueue; execution follows on the
device stream). Slot recycling relies on the order of host dispatch: a
block is evicted only with ``refs == 0``, and a lease is held across its
gather's dispatch, so a publish that reuses the slot is enqueued after the
gather that read it. The port runs every engine on the device's one stream
(it creates no side stream), so the order of host enqueue is the order on
the device, and no device-side synchronization is needed. A later side
stream for the copies would need a ``wait_stream`` here.

Telemetry and robustness planes are bound once at construction: the
``kv`` fault site (``pool_exhausted``, ``evict_storm``) and the ``pressure``
site (``hbm_squeeze@phase=publish``) fire in :meth:`KVPool.publish`; the
``corrupt`` site (``bit_flip@surface=kv``) in a sampled gather verification;
the recorder gets the ``kv.*`` counts and the ``kv_pool_exhausted``
instant; the attribution ledger the ``kv_arena:<model>`` component, the
copies' device time as ``kv_gather`` / ``kv_publish`` (CUDA-event stream
intervals, read once complete: no synchronization of their own), the
``evicted_kv`` tokens and :meth:`ChipTimeLedger.hbm_pressure` before a
truncated publish returns. The integrity plane stamps a digest on every
published block and verifies a deterministic sample of gathers.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, Optional

import torch

from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.kv.radix import RadixIndex
from llm_consensus_tpu_torch.models.transformer import cache_map, is_shard_list
from llm_consensus_tpu_torch.obs.attrib import DeviceWall
from llm_consensus_tpu_torch.ops.quant import kv_seq_axis


def _leaves(cache) -> Iterator[torch.Tensor]:
    """The cache's leaves in sorted key order (``k`` then ``v``; ``q8``
    then ``s``): the JAX package's tree order, so a block digest covers its
    leaves in the same order there and here. A sharded engine's cache (a
    list, one cache per attention position) yields each shard's in turn."""
    if is_shard_list(cache):
        for shard in cache:
            yield from _leaves(shard)
        return
    for name in sorted(cache):
        node = cache[name]
        if isinstance(node, dict):
            yield from _leaves(node)
        else:
            yield node


def _blocks(leaf: torch.Tensor, start: int, n_blocks: int, bs: int) -> torch.Tensor:
    """The ``n_blocks`` block-sized spans of ``leaf`` from sequence position
    ``start``, as a view with the sequence axis split into ``[n_blocks,
    bs]`` (block index on the sequence axis's dimension)."""
    ax = kv_seq_axis(leaf)
    span = leaf.narrow(ax, start, n_blocks * bs)
    return span.view(*leaf.shape[:ax], n_blocks, bs, *leaf.shape[ax + 1:])


def _gather(dst: dict, arena: dict, slots: torch.Tensor, bs: int) -> None:
    """Copy the arena blocks ``slots`` (in order) into positions ``[0, k *
    bs)`` of ``dst``: one ``index_select`` per leaf, written straight into
    the destination's view."""
    k = slots.numel()
    for d, a in zip(_leaves(dst), _leaves(arena)):
        ax = kv_seq_axis(a)
        src = _blocks(a, 0, a.shape[ax] // bs, bs)
        torch.index_select(src, ax, slots.to(a.device), out=_blocks(d, 0, k, bs))


def _scatter(arena: dict, src: dict, start: int, slots: torch.Tensor, bs: int) -> None:
    """Copy the ``k`` consecutive blocks of ``src`` from position ``start``
    into the arena slots ``slots``: one ``index_copy_`` per leaf."""
    k = slots.numel()
    for a, s in zip(_leaves(arena), _leaves(src)):
        ax = kv_seq_axis(a)
        _blocks(a, 0, a.shape[ax] // bs, bs).index_copy_(ax, slots.to(a.device),
                                                         _blocks(s, start, k, bs))


class KVPool:
    """Block-granular cross-request KV pool over one engine's cache layout.
    Built by :func:`llm_consensus_tpu_torch.kv.pool_for` (one pool per
    engine: arenas are layout-specific); thread-safe.

    ``budget_bytes`` sizes the arena: ``n_blocks = max(4, budget //
    (block_size x bytes_per_token))``, where ``bytes_per_token`` counts the
    K and V of every layer (codes plus scales for the int8 cache).

    ``new_cache(n_slots)`` makes the arena in the engine's cache layout (a
    sharded engine's: one arena per attention position, each of its Hkv /
    tp heads on its device). The radix, the block ids, the LRU and eviction
    stay single: a block id names the same slots in every shard's arena,
    and each copy moves every shard's blocks; a digest covers every shard's
    bytes, and the byte counts sum over the shards."""

    def __init__(self, cfg, *, dtype: torch.dtype, kv_quant: Optional[str],
                 device: torch.device, max_seq: int, block_size: int, budget_bytes: float,
                 new_cache: Callable[[int], object]):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.cfg = cfg
        self.block_size = block_size
        self.max_seq = max_seq
        self.device = torch.device(device)
        self._dtype = dtype
        self._kv_quant = kv_quant
        itemsize = dtype.itemsize
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
        if kv_quant == "int8":
            self.bytes_per_token = per_tok + 2 * cfg.n_layers * cfg.n_kv_heads * itemsize
        else:
            self.bytes_per_token = per_tok * itemsize
        self.n_blocks = max(4, int(budget_bytes // (block_size * self.bytes_per_token)))
        self._lock = threading.Lock()
        with torch.inference_mode():
            self._arena = new_cache(self.n_blocks * block_size)  # guarded by: _lock
        self._free = list(range(self.n_blocks))  # guarded by: _lock
        self._radix = RadixIndex(block_size)  # guarded by: _lock
        # Copies' stream intervals not yet booked (read once complete).
        self._walls: list = []  # guarded by: _lock
        self._faults = faults.plan()
        self._obs = obs.recorder()
        self._integrity = integrity.plane()
        self._attrib = obs.attrib.ledger()
        if self._attrib is not None:
            self._attrib.update_component(
                f"kv_arena:{cfg.name}", int(self.n_blocks * block_size * self.bytes_per_token))
        self._stats = {  # guarded by: _lock
            "lookups": 0, "hits": 0, "hit_tokens": 0, "miss_tokens": 0,
            "published_blocks": 0, "evicted_blocks": 0, "exhausted": 0,
            # Blocks that arrive by a disaggregated handoff rather than a
            # local retain (``publish(source="handoff")``).
            "handoff_blocks": 0,
            # Gathered blocks digest-verified, and blocks whose verification
            # failed (their chain dropped, the reuse recomputed).
            "verified_blocks": 0, "corrupt_blocks": 0,
        }

    @classmethod
    def for_engine(cls, engine) -> "KVPool":
        return cls(engine.cfg, dtype=engine.dtype, kv_quant=engine.kv_quant,
                   device=engine.device, max_seq=engine.max_seq,
                   block_size=max(1, engine.kv_pool_block),
                   budget_bytes=engine.kv_pool_mb * 1e6,
                   new_cache=lambda n_slots: engine.new_cache(1, n_slots))

    @property
    def arena_bytes(self) -> int:
        """The arena's bytes as allocated (the modeled component's size)."""
        return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(self._arena))

    def _index(self, values: list) -> torch.Tensor:
        """Block indices on the device: a pinned, asynchronous copy on a
        card (no host sync)."""
        t = torch.tensor(values, dtype=torch.long)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _wall(self) -> Optional[DeviceWall]:
        return DeviceWall(self.device) if self._attrib is not None else None

    def _book_walls_locked(self) -> None:
        """Book every finished copy's stream interval with the ledger (there
        are none without one)."""
        if not self._walls:
            return
        pending = []
        for family, wall in self._walls:
            if wall.done():
                self._attrib.observe_device(family, wall.seconds())
            else:
                pending.append((family, wall))
        self._walls = pending

    # -- integrity (block content digests) -------------------------------------

    def block_digest(self, cache: dict, start: int, flip_bit: bool = False) -> str:
        """Content digest of the block-sized span at ``start`` across every
        leaf of ``cache``: the unit a copy moves, so a digest stamped from
        the publish source equals one of the same span read back from a
        gathered cache (exact bytes). Takes a host copy of each leaf's span
        (a synchronization): only paths with the integrity plane on call
        it. ``flip_bit`` XORs one bit into the first leaf's host copy, the
        ``bit_flip`` fault's injection point."""
        bs = self.block_size
        crc = 0
        for i, leaf in enumerate(_leaves(cache)):
            blk = leaf.narrow(kv_seq_axis(leaf), start, bs).contiguous().cpu()
            if flip_bit and i == 0:
                blk = blk.clone()
                blk.reshape(-1).view(torch.uint8)[0] ^= 1
            crc = integrity.crc32_str(integrity.digest_array(blk), crc)
        return f"{crc:08x}"

    # -- lookup (radix match + gather) -----------------------------------------

    def lookup(self, ids: list, min_tokens: int) -> tuple[int, Optional[dict]]:
        """``(matched tokens, gathered [1, max_seq] cache)``: the pool's
        replacement for the engine's snapshot ``_reusable_prefix``.

        The match is capped at ``len(ids) - 1`` (at least one token must
        prefill to give next-token logits) and floors to a miss below
        ``min_tokens`` or when the restored prefix plus the chunk-rounded
        tail would overrun ``max_seq`` (the engine's reuse bound, applied
        here so no gather is dispatched for a reuse the engine would
        refuse). A sampled verification that finds a block's digest changed
        drops the chain and reports a miss. Those are the only misses: a
        failing copy raises.

        The returned cache holds the exact block bytes at ``[0, k x bs)``;
        the rest is left unwritten (never zeroed here): the caller masks at
        the matched length, which also clears the matched tail block's bytes
        past the match (``_restore_prefix_owned``, ``_fork_prefix``)."""
        bs = self.block_size
        with self._lock:
            self._stats["lookups"] += 1
            n, chain = self._radix.match(list(ids))
            n = min(n, len(ids) - 1)
            k = -(-n // bs) if n > 0 else 0
            chunk = max(1, min_tokens)
            tail_rounded = -(-(len(ids) - n) // chunk) * chunk
            if (n < min_tokens or k == 0 or k * bs > self.max_seq
                    or n + tail_rounded > self.max_seq):
                self._stats["miss_tokens"] += len(ids)
                return 0, None
            lease = chain[:k]
            for b in lease:
                b.refs += 1
            self._stats["hits"] += 1
            self._stats["hit_tokens"] += n
            self._stats["miss_tokens"] += len(ids) - n
            # Dispatch INSIDE the lock: slot recycling relies on the order
            # of host dispatch (this gather before any publish that reuses a
            # leased slot), see the module docstring.
            try:
                self._book_walls_locked()
                wall = self._wall()
                with torch.inference_mode():
                    dst = self._empty_cache()
                    _gather(dst, self._arena, self._index([b.slot for b in lease]), bs)
                if wall is not None:
                    self._walls.append(("kv_gather", wall.stop()))
            finally:
                for b in lease:
                    b.refs -= 1
            if self._integrity is not None and self._integrity.sample_hit():
                # Sampled gather verification: re-digest the gathered spans
                # against their publish-time digests. A mismatch drops the
                # whole chain from the index and reports a MISS: the caller
                # prefills, so reuse is lost but no stream decodes over
                # corrupt bytes.
                flip = False
                if self._faults is not None:
                    fs = self._faults.fire("corrupt", surface="kv", model=self.cfg.name)
                    flip = fs is not None and fs.kind == "bit_flip"
                for i, b in enumerate(lease):
                    if b.digest is None:
                        continue  # published before the plane came up
                    self._integrity.check("kv")
                    self._stats["verified_blocks"] += 1
                    got = self.block_digest(dst, i * bs, flip_bit=flip and i == 0)
                    if got != b.digest:
                        self._integrity.failure("kv", f"gather digest mismatch at slot {b.slot}")
                        self._stats["corrupt_blocks"] += 1
                        self._free.extend(self._radix.drop(b))
                        return 0, None
        if self._obs is not None:
            self._obs.count("kv.hit_tokens", n)
        return n, dst

    def _empty_cache(self):
        """An unwritten ``[1, max_seq]`` cache of the arena's layout: the
        gather fills its blocks and the caller masks the rest, so it is never
        zeroed (that would write the whole cache once more)."""
        def empty(leaf: torch.Tensor) -> torch.Tensor:
            shape = list(leaf.shape)
            shape[kv_seq_axis(leaf)] = self.max_seq
            return torch.empty(shape, dtype=leaf.dtype, device=leaf.device)

        return cache_map(empty, self._arena)

    # -- publish (scatter + radix insert) --------------------------------------

    def publish(self, ids: list, cache: dict, source: str = "local") -> tuple[int, bool]:
        """Copy ``ids``'s KV blocks from a finished left-aligned ``[1, S]``
        ``cache`` into the arena and index them: the pool's replacement for
        snapshot retention. Incremental: only blocks the radix does not hold
        yet are written (a repeated prompt costs a host walk and no device
        work). Returns ``(blocks written, truncated)``; ``truncated`` is True
        when exhaustion dropped the tail, from every ``source`` (``"local"``
        for a retain, ``"handoff"`` for a disaggregated handoff).

        Divergence is copy-on-write by construction: the plan writes fresh
        blocks for any span that extends or forks a chain, and an attached
        block is never rewritten. When the free list runs dry, LRU
        unreferenced blocks are evicted; when nothing is evictable the
        publish truncates (the prefix that fit stays servable)."""
        bs = self.block_size
        leaf = next(_leaves(cache))
        cache_cap = leaf.shape[kv_seq_axis(leaf)]
        # Whole in-capacity block spans only: a partial tail block's copy
        # still reads [start, start + bs), which must lie inside the cache.
        n = min(len(ids), (cache_cap // bs) * bs)
        if n < 1:
            return 0, False
        exhausted_inject = False
        squeeze_limit = None
        if self._faults is not None:
            fs = self._faults.fire("kv", model=self.cfg.name)
            if fs is not None:
                if fs.kind == "pool_exhausted":
                    exhausted_inject = True
                elif fs.kind == "evict_storm":
                    with self._lock:
                        freed = self._radix.evict(self.n_blocks)
                        self._free.extend(freed)
                        self._stats["evicted_blocks"] += len(freed)
                    if self._obs is not None and freed:
                        self._obs.count("kv.evicted_blocks", len(freed))
                    if self._attrib is not None and freed:
                        self._attrib.token_event("evicted_kv", len(freed) * bs)
            # hbm_squeeze (site ``pressure``, phase=publish): the arena
            # shrinks to @frac= of its blocks for this publish, the same
            # truncation path as real exhaustion under a pool that looks
            # healthy.
            fs = self._faults.fire("pressure", phase="publish", model=self.cfg.name)
            if fs is not None and fs.kind == "hbm_squeeze":
                squeeze_limit = max(0, int(self.n_blocks * float(fs.param("frac", 0.5))))
        wrote = 0
        evicted = 0
        truncated = False
        pressure_info = None  # fired after the lock: a flight-recorder dump
        # must not stall concurrent gathers and publishes under pressure.
        with self._lock:
            node, _base, writes = self._radix.plan_insert(list(ids[:n]))
            if not writes:
                return 0, False
            slots: list[int] = []
            for _ in writes:
                if exhausted_inject:
                    break
                if squeeze_limit is not None and self.n_blocks - len(self._free) >= squeeze_limit:
                    break  # the squeezed arena has no slot to grant
                if not self._free:
                    freed = self._radix.evict(max(1, len(writes) - len(slots)))
                    evicted += len(freed)
                    self._stats["evicted_blocks"] += len(freed)
                    self._free.extend(freed)
                if not self._free:
                    break
                slots.append(self._free.pop())
            if len(slots) < len(writes):
                # Exhausted (every block interior or leased, an injected
                # fault, or a squeezed arena): publish the prefix that fits.
                # Chains stay gap-free, so the tail past the last granted
                # slot is dropped, never skipped over.
                if self._attrib is not None:
                    pressure_info = {"wanted": len(writes), "granted": len(slots),
                                     "blocks_total": self.n_blocks,
                                     "blocks_free": len(self._free)}
                self._stats["exhausted"] += 1
                truncated = True
                if self._obs is not None:
                    self._obs.instant("kv_pool_exhausted", tid="kv", wanted=len(writes),
                                      granted=len(slots), source=source)
                    self._obs.count("kv.exhausted")
                writes = writes[:len(slots)]
            if writes:
                self._book_walls_locked()
                wall = self._wall()
                with torch.inference_mode():
                    # Writes are consecutive blocks from a block boundary.
                    _scatter(self._arena, cache, writes[0][0], self._index(slots), bs)
                if wall is not None:
                    self._walls.append(("kv_publish", wall.stop()))
                # Attach only after the copy is enqueued, so no lease can
                # cover bytes that are not at least in flight to the arena;
                # deduped writes (unreachable under this lock) hand their
                # slots back.
                attached = self._radix.attach(node, writes, slots)
                used = {b.slot for b in attached}
                self._free.extend(slot for slot in slots if slot not in used)
                if self._integrity is not None and attached:
                    # Each attached block's digest from the publish SOURCE:
                    # the copy moves exact bytes, so a later gather of the
                    # span must reproduce it.
                    starts = {slot: start for (start, _t), slot in zip(writes, slots)}
                    for blk in attached:
                        blk.digest = self.block_digest(cache, starts[blk.slot])
                wrote = len(attached)
                self._stats["published_blocks"] += wrote
                if source == "handoff":
                    self._stats["handoff_blocks"] += wrote
        if pressure_info is not None:
            self._attrib.hbm_pressure(f"kv_pool:{self.cfg.name}", **pressure_info)
        if self._obs is not None:
            if wrote:
                self._obs.count("kv.published_blocks", wrote)
            if evicted:
                self._obs.count("kv.evicted_blocks", evicted)
        if self._attrib is not None and evicted:
            # Tokens whose KV was computed, published and then dropped: the
            # recompute exposure of eviction.
            self._attrib.token_event("evicted_kv", evicted * bs)
        return wrote, truncated

    def evict_cold(self, target_occupancy: float) -> int:
        """Evict cold (unreferenced, LRU) blocks until arena occupancy is at
        or below ``target_occupancy``; returns the blocks freed (fewer when
        the rest is leased or interior). No device work: eviction only
        recycles slots."""
        target = min(1.0, max(0.0, float(target_occupancy)))
        with self._lock:
            used = self.n_blocks - len(self._free)
            want = used - int(target * self.n_blocks)
            if want <= 0:
                return 0
            freed = self._radix.evict(want)
            self._free.extend(freed)
            self._stats["evicted_blocks"] += len(freed)
        if self._obs is not None and freed:
            self._obs.count("kv.evicted_blocks", len(freed))
        if self._attrib is not None and freed:
            self._attrib.token_event("evicted_kv", len(freed) * self.block_size)
        return len(freed)

    def covers(self, ids: list) -> bool:
        """True when the radix already holds ``ids``'s whole-block span: the
        admission wave's retention gate (the snapshot path's ``_prefix_ids
        != rows[0]``). Whole blocks on purpose: past the covered span a
        repeat wave has only a sub-block tail, which is not worth a row-0
        extraction of a whole cache."""
        n = (len(ids) // self.block_size) * self.block_size
        if n < 1:
            return True
        with self._lock:
            return self._radix.covered(list(ids[:n])) >= n

    def match_len(self, ids: list) -> int:
        """Radix-resident prefix length of ``ids``: a host-only trie walk
        (no lease, no gather; it touches the chain's LRU stamps). The
        batcher's admission planning sizes a wave's shared prefix to it."""
        with self._lock:
            n, _chain = self._radix.match(list(ids))
        return n

    # -- introspection -----------------------------------------------------------

    def stats(self) -> dict:
        """Occupancy and traffic counters (``metrics.json``'s ``kv`` block):
        the JAX pool's keys."""
        with self._lock:
            self._book_walls_locked()
            used = self.n_blocks - len(self._free)
            out = dict(self._stats)
        out.update(
            block_size=self.block_size,
            blocks_total=self.n_blocks,
            blocks_used=used,
            occupancy=round(used / max(1, self.n_blocks), 4),
            bytes_per_token=self.bytes_per_token,
        )
        return out

