"""Consensus result cache: LRU + TTL, with single-flight coalescing (a copy
of ``llm_consensus_tpu/serve/cache.py``).

Two cooperating pieces, both stdlib-only and thread-safe:

  * :class:`ConsensusCache` — a bounded LRU of finished consensus results
    keyed by the full request identity (panel, judge, sampling, system,
    prompt). Entries expire after ``ttl_s``; capacity evicts
    least-recently-used. A hit costs one dict move, no model runs.
  * :class:`Flight` / :class:`FlightTable` — single-flight execution: the
    first request for a key becomes the *leader* and runs the panel; every
    identical request arriving while the leader is in flight becomes a
    *follower* that subscribes to the leader's chunk stream and final
    result. A thundering herd of M identical prompts costs exactly one
    panel+judge execution and produces M streamed responses.

The cache key deliberately covers everything that changes the answer —
panel composition *in order* (a panel asked twice is two queries, so
multiplicity matters), judge, sampling (max_tokens), system prompt, and a
digest of the prompt text — and nothing that doesn't (run ids, deadlines,
stream vs JSON shape).

Followers replay the leader's buffered chunks first, then follow live, so
a follower that joins mid-run still streams the complete response from
chunk zero — the gateway's SSE UX is identical whether a request led,
followed, or hit the cache.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from typing import Callable, Iterator, Optional

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.utils.context import Context


def cache_key(
    models: list[str],
    judge: Optional[str],
    prompt: str,
    system: Optional[str] = None,
    max_tokens: Optional[int] = None,
) -> str:
    """Digest of the full request identity (see module docstring)."""
    doc = json.dumps(
        {
            "models": list(models),
            "judge": judge,
            "system": system or "",
            "max_tokens": max_tokens,
            "prompt": prompt,
        },
        sort_keys=True,
        ensure_ascii=False,
    )
    return hashlib.sha256(doc.encode("utf-8")).hexdigest()


class _Entry:
    __slots__ = ("value", "expires_at")

    def __init__(self, value, expires_at: float):
        self.value = value
        self.expires_at = expires_at


class ConsensusCache:
    """Bounded LRU + TTL map of finished consensus results.

    ``clock`` is injectable (tests drive TTL expiry without sleeping);
    production uses ``time.monotonic``. Stored values are treated as
    immutable — a hit hands back the same object to many requests.
    """

    def __init__(
        self,
        capacity: int = 256,
        ttl_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = sanitizer.make_lock("serve.cache")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expirations = 0

    def get(self, key: str):
        """The cached value, or None (miss / expired). Refreshes LRU order."""
        now = self._clock()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            if now >= entry.expires_at:
                del self._entries[key]
                self.expirations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry.value

    def put(self, key: str, value) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = _Entry(value, self._clock() + self.ttl_s)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "expirations": self.expirations,
            }


class FlightFailed(RuntimeError):
    """The leader's execution failed; followers re-raise its error."""


class Flight:
    """One in-progress execution fanning chunks out to followers.

    The leader calls :meth:`publish` per chunk and exactly one of
    :meth:`finish` / :meth:`fail`; followers iterate :meth:`stream` (full
    replay from chunk zero, then live) and read :meth:`result`.
    """

    def __init__(self, key: str):
        self.key = key
        self._cond = sanitizer.make_condition("serve.cache.flight")
        self._chunks: list[tuple[str, str, str]] = []  # (kind, model, text)
        self._done = False
        self._result = None
        self._error: Optional[BaseException] = None
        self.followers = 0

    def publish(self, kind: str, model: str, text: str) -> None:
        with self._cond:
            self._chunks.append((kind, model, text))
            self._cond.notify_all()

    def finish(self, result) -> None:
        with self._cond:
            self._done = True
            self._result = result
            self._cond.notify_all()

    def fail(self, error: BaseException) -> None:
        with self._cond:
            self._done = True
            self._error = error
            self._cond.notify_all()

    def stream(self, ctx: Optional[Context] = None) -> Iterator[tuple[str, str, str]]:
        """Yield every chunk (buffered, then live) until the flight ends.

        Cooperative with the follower's own request context: expiry or
        cancel raises out of the iteration rather than waiting on a
        leader the follower no longer cares about.
        """
        i = 0
        while True:
            with self._cond:
                while i >= len(self._chunks) and not self._done:
                    if ctx is not None:
                        ctx.raise_if_done()
                        rem = ctx.remaining()
                        self._cond.wait(0.25 if rem is None else min(0.25, rem))
                    else:
                        self._cond.wait()
                if i < len(self._chunks):
                    chunk = self._chunks[i]
                else:
                    return  # done, fully drained
            i += 1
            yield chunk

    def result(self, ctx: Optional[Context] = None):
        """Block until the leader finishes; return its result or re-raise
        its failure (wrapped, so the follower's traceback says so)."""
        with self._cond:
            while not self._done:
                if ctx is not None:
                    ctx.raise_if_done()
                    rem = ctx.remaining()
                    self._cond.wait(0.25 if rem is None else min(0.25, rem))
                else:
                    self._cond.wait()
            if self._error is not None:
                raise FlightFailed(
                    f"coalesced run failed: {self._error}"
                ) from self._error
            return self._result


class FlightTable:
    """Single-flight registry: one live :class:`Flight` per key."""

    def __init__(self) -> None:
        self._lock = sanitizer.make_lock("serve.cache.flights")
        self._flights: dict[str, Flight] = {}

    def begin(self, key: str) -> tuple[Flight, bool]:
        """Join ``key``'s live flight (follower) or start one (leader)."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.followers += 1
                return flight, False
            flight = Flight(key)
            self._flights[key] = flight
            return flight, True

    def end(self, flight: Flight) -> None:
        """Retire the leader's flight: later identical requests start a
        fresh one (or hit the cache). Idempotent."""
        with self._lock:
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]

    def depth(self) -> int:
        with self._lock:
            return len(self._flights)

    def followers(self) -> int:
        """Followers currently riding live flights (stats / tests)."""
        with self._lock:
            return sum(f.followers for f in self._flights.values())
