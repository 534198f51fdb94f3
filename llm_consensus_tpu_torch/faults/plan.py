"""Deterministic, seeded fault injection (a copy of
``llm_consensus_tpu/faults/plan.py``).

A :class:`FaultPlan` is built once from a spec string + seed and consulted
at named *sites* threaded through the stack:

  site        kinds              where it fires
  ---------   ----------------   ------------------------------------------
  prefill     prefill_oom        Engine._prefill_ids / _prefill_rows[_suffix]
  decode      decode_fault       Engine.generate_ids / ContinuousBatcher._loop
                                 decode-chunk dispatch
  build       build_fail         TPUProvider._build_engine
  sse         sse_reset          http_sse.post_sse (mid-stream reset)
  runner      worker_stall       Runner worker threads (non-cooperative sleep)
  allgather   controller_drop    multicontroller.allgather_bytes_bounded
              controller_late    (simulated dead / late peer)
  serve       queue_full         serve/admission (forced 429 rejection)
              slow_admit         serve/admission (delayed slot grant; @s=secs)
              disconnect         serve/gateway (client vanishes mid-SSE-stream)
              migrate_stall      serve/gateway migrate loop (phase=migrate:
                                 the destination is slow to accept one
                                 resident stream — @stream=N matches the
                                 Nth resident; the source falls back to
                                 finishing that stream locally, so a
                                 stalled migration degrades to the
                                 drain-and-wait path, never a drop)
  engine      crash              ContinuousBatcher._loop (pool-fatal death
                                 mid-decode — the recovery supervisor's
                                 restart-and-replay trigger)
              wedge              ContinuousBatcher._loop (non-cooperative
                                 stall freezing the decode heartbeat;
                                 @s=secs, default 600)
  router      replica_down       serve/router proxy loop (the replica's
                                 connection dies mid-stream — the fleet
                                 failover trigger; @frame=N matches the
                                 Nth SSE frame of ONE replica attempt —
                                 an attr, so concurrent polls advancing
                                 the site counter can't shift it)
              slow_healthz       serve/fleet health prober (one poll comes
                                 back slow/failed; @s=secs — hysteresis
                                 must absorb it, never flap to dead)
              partition          serve/router proxy connect (the replica
                                 is unreachable before any byte moves)
              replica_flap       serve/elastic controller tick (phase=
                                 elastic: the load signal oscillates for
                                 @s=secs as if a replica were join/leave
                                 flapping — the two-sided scale
                                 hysteresis must absorb it without a
                                 scale decision)
                                 Qualify router specs with @phase=
                                 (connect|proxy|poll|elastic) so one kind
                                 never consumes another phase's fire.
  kv          pool_exhausted     kv/pool.KVPool.publish (the publish grants
                                 no arena slots — the tail past what fit is
                                 truncated; reuse lost, never correctness)
              evict_storm        kv/pool.KVPool.publish (every unreferenced
                                 block evicts before the publish plans —
                                 the radix survives losing its whole
                                 resident set mid-traffic)
  pressure    hbm_squeeze        kv/pool.KVPool.publish (phase=publish:
                                 the effective arena shrinks to @frac=
                                 of its blocks for this publish — the
                                 exhaustion/truncation path fires under
                                 a healthy-sized pool, which is exactly
                                 the signal the pressure governor's
                                 ladder escalates on)
              priority_storm     pressure/governor sample tick
                                 (phase=governor: flood @n= synthetic
                                 LOW-priority admits through the real
                                 admission controller, each holding its
                                 slot @s= seconds — the overload the
                                 ladder must absorb while the HIGH class
                                 keeps completing)
                                 Qualify pressure specs with @phase=
                                 (publish|governor) so one kind never
                                 consumes the other phase's fire.
  spec        acceptance_collapse  speculative round dispatch (engine/
                                 speculative.py + ContinuousBatcher spec
                                 mode): this round's proposals become
                                 junk — greedy output stays exact for
                                 ANY proposals, so acceptance pins to ~1
                                 and the adaptive-k/governor machinery
                                 must absorb a pure SPEED fault
              draft_stall        speculative round dispatch (host
                                 dispatcher sleep; @s=secs, default
                                 0.05 — the governor's A/B must lock
                                 plain rather than ride a stalled
                                 drafter)
  swap        swap_mid_stream    Engine.swap_weights (phase=apply: the
                                 swap request lands while streams hold
                                 pins — forces the pending/double-buffer
                                 path instead of an immediate flip, so
                                 tests exercise pinned residents draining
                                 the old buffer)
              canary_regress     flywheel canary decode dispatch (the
                                 canary-version engine's decode slows by
                                 @s=secs per chunk, default 0.05 — the
                                 latency regression the CanaryWatcher
                                 must catch and auto-roll-back)
              corpus_corrupt     flywheel/corpus extraction (one run
                                 dir's result.json reads as garbage —
                                 the scanner must skip it and count it,
                                 never abort the corpus build)
  disagg      handoff_stall      engine/handoff.KVHandoff worker wave
                                 (@s=secs, default 0.2: the prefill
                                 worker sleeps before its wave, so
                                 waiting submitters hit the bounded-
                                 wait fallback and the handoff queue
                                 backpressures admission)
              prefill_worker_crash  engine/handoff.KVHandoff worker wave
                                 (@wave=N matches the Nth wave: that
                                 wave's prefill dies — its tickets fall
                                 back per-wave to the classic
                                 interleaved-admission path; reuse
                                 lost, never correctness)
  corrupt     bit_flip           integrity verification boundaries
                                 (@surface=kv|wal|ckpt|migration picks
                                 the seam: one bit flips in the
                                 host-visible copy right before its
                                 digest/CRC verify — the plane must
                                 detect it there, contain it, and
                                 repair via recompute/truncate/refuse)
              nan_logits         engine decode-chunk dispatch
                                 (@row=N poisons row N's logits inside
                                 the fused program — the finite-logit
                                 sentinel's per-row verdict must fail
                                 only that stream, with a typed
                                 IntegrityError terminal; neighbors
                                 stay byte-identical)
              torn_wal_tail      recovery/journal WAL close (the last
                                 record's write tears mid-line — the
                                 torn-tail reader must truncate to the
                                 last good record and feed the normal
                                 replay contract)

Spec grammar (``LLMC_FAULTS``)::

    spec   := fault ("," fault)*
    fault  := kind ("@" key "=" value)*

e.g. ``LLMC_FAULTS="prefill_oom@step=3,controller_drop@host=1,sse_reset@chunk=2"``.

Qualifier keys:

  * ``step`` / ``chunk`` — match the site's dispatch counter (1-indexed;
    ``sse_reset@chunk=2`` replaces the 2nd SSE data event with a reset).
  * ``p`` — fire probabilistically; draws come from the plan's seeded RNG,
    so the *sequence* of decisions is a pure function of (seed, spec, call
    order) — same seed ⇒ byte-identical fault sequence.
  * ``times`` — fire at most N times (default 1; ``-1`` = unlimited).
  * any key a site passes as an attribute (``model``, ``preset``) — must
    match exactly.
  * anything else (``host``, ``s``) — a parameter the firing site
    interprets, never a matcher.

Every ``fire()`` appends one line to ``plan.trace`` regardless of outcome,
so two plans driven through the same call sequence are comparable
byte-for-byte via :meth:`FaultPlan.trace_bytes` (asserted in
tests/test_faults.py).

The site table and the grammar are the JAX package's whole, so every spec
string parses as there; the port fires the sites of the modules it has
(prefill, decode, build, sse, runner, engine, the KV pool's ``kv``
(``pool_exhausted``, ``evict_storm``), ``pressure`` (``hbm_squeeze@phase=publish``
and the governor's ``priority_storm``), ``serve`` (``queue_full``,
``slow_admit``, ``disconnect``, ``migrate_stall``), ``router``
(``replica_down``, ``slow_healthz``, ``partition``, ``replica_flap``),
``swap`` (``swap_mid_stream``, ``canary_regress``, and ``corpus_corrupt`` in
``flywheel/corpus.py``), ``disagg`` (``handoff_stall``,
``prefill_worker_crash``, engine/handoff.py), and ``corrupt`` with
``nan_logits``, the WAL surfaces, ``bit_flip@surface=kv``, ``@surface=ckpt``
and ``@surface=handoff``). The CLI installs the plan
(faults/__init__.py); consumers bind ``self._faults = faults.plan()`` at
construction time, so without a plan the hot dispatch paths carry a single
``is not None`` check and no injector code runs.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional

# site -> kinds that can fire there
SITE_KINDS: dict[str, tuple[str, ...]] = {
    "prefill": ("prefill_oom",),
    "decode": ("decode_fault",),
    "build": ("build_fail",),
    "sse": ("sse_reset",),
    "runner": ("worker_stall",),
    "allgather": ("controller_drop", "controller_late"),
    "serve": ("queue_full", "slow_admit", "disconnect", "migrate_stall"),
    "engine": ("crash", "wedge"),
    "router": ("replica_down", "slow_healthz", "partition", "replica_flap"),
    "kv": ("pool_exhausted", "evict_storm"),
    "spec": ("acceptance_collapse", "draft_stall"),
    "pressure": ("hbm_squeeze", "priority_storm"),
    "disagg": ("handoff_stall", "prefill_worker_crash"),
    "swap": ("swap_mid_stream", "canary_regress", "corpus_corrupt"),
    "corrupt": ("bit_flip", "nan_logits", "torn_wal_tail"),
}

KNOWN_KINDS = frozenset(k for kinds in SITE_KINDS.values() for k in kinds)

# Keys that participate in matching even though sites never pass them as
# attributes. Everything else unknown is a parameter for the firing site.
_COUNTER_KEYS = ("step", "chunk")


class InjectedFault(RuntimeError):
    """A fault fired by the injection plan (never raised in production:
    nothing fires without an installed FaultPlan)."""


@dataclass
class FaultSpec:
    """One parsed fault from the spec string."""

    kind: str
    args: dict = field(default_factory=dict)
    times: int = 1  # remaining fires; -1 = unlimited

    def param(self, key: str, default=None):
        return self.args.get(key, default)


def parse_spec(spec: str) -> list[FaultSpec]:
    """Parse ``LLMC_FAULTS`` grammar into FaultSpecs (order-preserving)."""
    out: list[FaultSpec] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split("@")
        kind = fields[0].strip()
        if kind not in KNOWN_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in LLMC_FAULTS "
                f"(known: {sorted(KNOWN_KINDS)})"
            )
        args: dict = {}
        for f in fields[1:]:
            f = f.strip()
            if not f:
                continue
            if "=" not in f:
                raise ValueError(
                    f"malformed fault qualifier {f!r} in {part!r} "
                    "(expected key=value)"
                )
            key, _, value = f.partition("=")
            args[key.strip()] = value.strip()
        times = int(args.pop("times", 1))
        out.append(FaultSpec(kind=kind, args=args, times=times))
    return out


class FaultPlan:
    """Seeded, thread-safe fault schedule over named sites.

    ``fire(site, **attrs)`` advances the site's counter, decides whether any
    spec fires, records the decision in ``trace``, and returns the fired
    spec (or None). ``check(site, **attrs)`` is the raising form for sites
    whose faults model a device/runtime error.
    """

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._specs = parse_spec(spec)
        self._rng = random.Random(seed)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self.trace: list[str] = []

    def _matches(self, fs: FaultSpec, n: int, attrs: dict) -> bool:
        p: Optional[float] = None
        for key, value in fs.args.items():
            if key == "p":
                p = float(value)  # drawn LAST, below — see comment
            elif key in _COUNTER_KEYS:
                if int(value) != n:
                    return False
            elif key in attrs:
                if str(attrs[key]) != str(value):
                    return False
            # else: a site parameter (host=, s=, ...) — never a matcher.
        if p is not None:
            # The draw happens only after every OTHER qualifier matched —
            # regardless of where p= sits in the spec string — so the RNG
            # stream consumed is a function of the matching call sequence
            # alone, and qualifier ordering cannot shift later
            # probabilistic decisions.
            return self._rng.random() < p
        return True

    def fire(self, site: str, **attrs) -> Optional[FaultSpec]:
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            hit: Optional[FaultSpec] = None
            for fs in self._specs:
                if fs.kind not in SITE_KINDS.get(site, ()):
                    continue
                if fs.times == 0:
                    continue
                if not self._matches(fs, n, attrs):
                    continue
                if fs.times > 0:
                    fs.times -= 1
                hit = fs
                break
            tags = ",".join(f"{k}={attrs[k]}" for k in sorted(attrs))
            self.trace.append(
                f"{site}#{n}[{tags}]->{hit.kind if hit else '-'}"
            )
        if hit is not None:
            # Every injected fault lands on the run timeline (obs/; no-op
            # when telemetry is off). Resolved per fire, outside the plan
            # lock: faults only ever fire under chaos, never on a clean
            # run's hot path, and tests install recorder and plan in
            # either order.
            from llm_consensus_tpu_torch import obs

            r = obs.recorder()
            if r is not None:
                r.instant(
                    f"fault:{hit.kind}", tid="faults", site=site, n=n,
                    **{k: str(v) for k, v in attrs.items()},
                )
        return hit

    def check(self, site: str, **attrs) -> None:
        """Raise :class:`InjectedFault` when a fault fires at ``site``."""
        fs = self.fire(site, **attrs)
        if fs is not None:
            raise InjectedFault(
                f"injected {fs.kind} at site {site!r} "
                f"(spec {self.spec!r}, seed {self.seed})"
            )

    def trace_bytes(self) -> bytes:
        """The decision sequence, serialized — byte-identical for two plans
        with the same (seed, spec) driven through the same call sequence."""
        with self._lock:
            return ("\n".join(self.trace) + "\n").encode("utf-8")
