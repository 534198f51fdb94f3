"""Block-granular radix index: token-id trie → arena block chains (a copy
of ``llm_consensus_tpu/kv/radix.py``: the same match, plan/attach split,
dedup, drop and LRU eviction with the same tick stamps, so one operation
sequence gives the same matches and the same eviction order in both
packages).

Host-side only (no device ops: the pool owns those), so every structural
invariant is unit-testable without a card. One node owns exactly ONE block
(``block_size`` tokens, the tree's granule): a 4k-token prompt is a
~64-node chain at the default 64-token block, which keeps splits trivial —
a chain that diverges mid-stream shares the common prefix NODES and
branches, so there is never an edge to split token by token.

Invariants:

  * Every block is FULL (``block_size`` tokens) except a chain's tail,
    and a partial block is always a LEAF: a node acquires children only
    once its block is full (``plan_insert`` never descends through a
    partial block).
  * Blocks are immutable once attached: divergent or extended tails get
    FRESH sibling blocks (copy-on-write at chain level; the shared full
    blocks stay shared through the trie structure, and the old tail keeps
    its bytes for whoever still matches it). Nothing ever rewrites an
    attached block's arena slot, so a concurrent reader's gathered bytes
    cannot change under it.
  * ``refs`` counts active leases (a match whose blocks are being
    gathered). Eviction only frees leaf blocks with ``refs == 0``, LRU by
    a monotonic touch stamp bumped on every match and insert along the
    path; interior nodes become evictable as their subtrees drain. The
    nodes one tick stamps lie on one root-to-leaf path, so no two
    candidate leaves ever share a stamp and the order is total.

Match is overlap-maximal: full blocks compare exactly; the final block of
a walk contributes its longest common prefix with the query, so a request
that diverges mid-block still reuses every matching token (the engine
masks gathered positions >= the matched length, as the snapshot restore
does).
"""

from __future__ import annotations

from typing import Callable, Optional


class Block:
    """One arena block: its slot, the token ids whose KV it holds, and
    the number of active leases pinning it against eviction."""

    __slots__ = ("slot", "tokens", "refs", "digest")

    def __init__(self, slot: int, tokens: tuple):
        self.slot = slot
        self.tokens = tokens
        self.refs = 0
        # Content digest of the block's arena bytes, stamped by the pool
        # at publish when the integrity plane is on (None otherwise).
        # Immutable like the bytes it covers.
        self.digest: Optional[str] = None

    def __repr__(self) -> str:  # debugging/test output only
        return f"Block(slot={self.slot}, n={len(self.tokens)}, refs={self.refs})"


class _Node:
    __slots__ = ("block", "children", "parent", "stamp")

    def __init__(self, block: Optional[Block], parent: "Optional[_Node]",
                 stamp: int):
        self.block = block          # None only at the root
        self.children: list[_Node] = []
        self.parent = parent
        self.stamp = stamp


class RadixIndex:
    """Token-id trie over block chains. NOT thread-safe — the pool holds
    its lock across every call (match/insert/evict are microseconds of
    pure-Python list walks)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.bs = block_size
        self.root = _Node(None, None, 0)
        self._clock = 0
        self.entries = 0  # attached blocks (== nodes below the root)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- match ---------------------------------------------------------------

    def match(self, ids: list) -> tuple[int, list[Block]]:
        """Longest stored prefix of ``ids``: (token count, block chain).

        Whole blocks must match exactly to descend; the last chain block
        contributes its partial overlap. The returned blocks cover
        exactly the matched tokens (the final one possibly partially) —
        the caller leases them (``refs += 1``) before releasing the
        index lock if it intends to gather.
        """
        node = self.root
        n = 0
        out: list[Block] = []
        stamp = self._tick()
        while True:
            best_child: Optional[_Node] = None
            best_overlap = 0
            for child in node.children:
                bt = child.block.tokens
                lim = min(len(bt), len(ids) - n)
                m = 0
                while m < lim and bt[m] == ids[n + m]:
                    m += 1
                if m > best_overlap:
                    best_overlap, best_child = m, child
            if best_child is None:
                return n, out
            best_child.stamp = stamp
            out.append(best_child.block)
            n += best_overlap
            if best_overlap < len(best_child.block.tokens) or (
                best_overlap < self.bs
            ):
                # Partial use of this block (divergence, query exhausted,
                # or a partial tail): the walk ends here.
                return n, out
            node = best_child

    def covered(self, ids: list) -> int:
        """Tokens of ``ids`` already stored verbatim along one chain —
        ``insert`` would write nothing when this equals ``len(ids)``
        (or leaves only a shorter partial tail than an existing one).
        Pure read: no stamps move."""
        node, n = self._walk_full(ids)
        best_tail = 0
        for child in node.children:
            bt = child.block.tokens
            lim = min(len(bt), len(ids) - n)
            if bt[:lim] == tuple(ids[n:n + lim]):
                best_tail = max(best_tail, lim)
        return n + best_tail

    # -- insert --------------------------------------------------------------

    def _walk_full(self, ids: list) -> tuple[_Node, int]:
        """Descend exact FULL-block matches only (the block-aligned
        attach point for an insert). Returns (node, tokens covered)."""
        node = self.root
        n = 0
        while len(ids) - n >= self.bs:
            want = tuple(ids[n:n + self.bs])
            nxt = None
            for child in node.children:
                if len(child.block.tokens) == self.bs and \
                        child.block.tokens == want:
                    nxt = child
                    break
            if nxt is None:
                break
            node = nxt
            n += self.bs
        return node, n

    def plan_insert(self, ids: list) -> tuple[_Node, int, list[tuple]]:
        """What an insert of ``ids`` must write: (attach node, covered
        tokens, [(token start, token tuple)] per NEW block, in chain
        order). Does NOT mutate the tree — the pool allocates slots and
        dispatches the scatter first, then calls :meth:`attach`, so the
        index never holds a block whose bytes are not at least in
        flight to the arena (true by ordering alone, independent of the
        caller's locking).

        Copy-on-write falls out here: when ``ids`` extends or diverges
        from an existing partial tail, the plan writes fresh blocks for
        the whole divergent span and the old tail stays attached
        untouched — no attached block is ever rewritten.
        """
        node, n = self._walk_full(ids)
        node_stamp = self._tick()
        cur = node
        while cur is not None:
            cur.stamp = node_stamp
            cur = cur.parent
        # An existing tail that already covers our remainder (equal or
        # longer overlap) makes the insert a no-op past n.
        rest = len(ids) - n
        if rest <= 0:
            return node, n, []
        for child in node.children:
            bt = child.block.tokens
            if len(bt) >= rest and bt[:rest] == tuple(ids[n:]):
                child.stamp = node_stamp
                return node, n, []
        writes = []
        start = n
        while start < len(ids):
            end = min(start + self.bs, len(ids))
            writes.append((start, tuple(ids[start:end])))
            start = end
        return node, n, writes

    def attach(self, node: _Node, writes: list[tuple], slots: list[int],
               ) -> list[Block]:
        """Attach freshly scattered blocks as a chain under ``node``.

        ``slots[i]`` is the arena slot ``writes[i]`` was scattered to.
        Re-validates the attach point: if another insert attached an
        identical chain between plan and attach, the duplicate full
        blocks dedup onto the existing nodes and only the genuinely new
        tail attaches. The index assumes nothing about caller locking —
        KVPool holds one lock across plan→attach so the dedup branch
        never fires there, but the guard keeps plan/attach safe to
        interleave on its own terms (tests drive it directly). Returns
        the blocks actually attached; slots of deduped writes are NOT
        consumed and the caller returns them to the free list.
        """
        stamp = self._tick()
        attached: list[Block] = []
        parent = node
        for (start, tokens), slot in zip(writes, slots):
            dup = None
            if len(tokens) == self.bs:
                for child in parent.children:
                    if child.block.tokens == tokens:
                        dup = child
                        break
            if dup is not None:
                dup.stamp = stamp
                parent = dup
                continue
            blk = Block(slot, tokens)
            child = _Node(blk, parent, stamp)
            parent.children.append(child)
            self.entries += 1
            attached.append(blk)
            parent = child
        return attached

    # -- containment ---------------------------------------------------------

    def drop(self, block: Block) -> list[int]:
        """Detach the node holding ``block`` plus its entire subtree and
        return their arena slots — the integrity plane's containment for
        a digest-mismatched gather. Descendant blocks' bytes may well be
        fine, but a chain is only reachable through its prefix, so the
        whole subtree returns to the free list and the next request
        re-prefills (reuse lost, never correctness). Called under the
        pool lock, where leases are only ever held transiently inside a
        single ``lookup`` — so unlike ``evict`` there is nothing to pin
        against."""
        target: Optional[_Node] = None
        stack = [self.root]
        while stack and target is None:
            cur = stack.pop()
            for child in cur.children:
                if child.block is block:
                    target = child
                    break
                stack.append(child)
        if target is None:
            return []
        target.parent.children.remove(target)
        freed: list[int] = []
        sub = [target]
        while sub:
            cur = sub.pop()
            self.entries -= 1
            freed.append(cur.block.slot)
            sub.extend(cur.children)
        return freed

    # -- eviction ------------------------------------------------------------

    def evict(self, need: int,
              on_evict: Optional[Callable[[Block], None]] = None,
              ) -> list[int]:
        """Free up to ``need`` arena slots, LRU leaves first.

        Only leaves (no children) with ``refs == 0`` are candidates —
        an interior block is load-bearing for its subtree and a leased
        block is mid-gather. Removing a leaf can expose its parent, so
        freed parents join the candidate heap with their own stamps:
        ONE trie walk + a heap serves any ``need`` (the pool holds its
        lock across this call — an evict_storm over a many-thousand
        block arena must not go quadratic under it). Returns the freed
        slots (oldest stamps first).
        """
        import heapq

        heap: list[tuple[int, int, _Node]] = []
        stack = [self.root]
        while stack:
            cur = stack.pop()
            for child in cur.children:
                if child.children:
                    stack.append(child)
                elif child.block.refs == 0:
                    heapq.heappush(heap, (child.stamp, id(child), child))
        freed: list[int] = []
        while heap and len(freed) < need:
            _, _, victim = heapq.heappop(heap)
            victim.parent.children.remove(victim)
            self.entries -= 1
            freed.append(victim.block.slot)
            if on_evict is not None:
                on_evict(victim.block)
            parent = victim.parent
            if parent is not self.root and not parent.children and \
                    parent.block.refs == 0:
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        return freed
