"""Model-check protocol fixtures: the bodies the port's schedule tests
explore through :func:`llm_consensus_tpu_torch.analysis.schedule.check`.

Each fixture is a zero-argument body that builds REAL protocol objects
(admission controller, handoff worker, supervisor watchdog — the thread
protocols the stack's correctness guarantees are implemented by),
drives them with a handful of controlled threads, and asserts the
protocol invariant at the end. Under
:func:`llm_consensus_tpu_torch.analysis.schedule.explore` every lock/
condition/event operation plus the ``sched_point`` seams become
scheduling decisions, so the seeded walk systematically explores the
interleavings the chaos runs only ever sample by luck.

The handoff fixture stubs the tensor wave (``_wave``) — the model
checker's subject is the ticket-queue/worker/submitter THREAD protocol,
not the math; the engine tests and ``chip_smoke.py`` cover the tensor
path on real tensors.

``planted_atomicity`` / ``planted_deadlock`` are the explorer's
self-checks: two known-bug bodies the explorer MUST find within a
bounded schedule budget, proving the harness can still see bugs before
it vouches for the protocol fixtures being clean.
"""

from __future__ import annotations

import threading

from llm_consensus_tpu_torch.analysis import sanitizer


# -- planted bugs (harness self-checks) ---------------------------------------


def planted_atomicity() -> None:
    """Check-then-act lost update: two bumpers read-then-write a
    guarded counter in separate critical sections. Some interleaving
    loses an update; the explorer must find it."""
    lock = sanitizer.make_lock("fixture.counter")
    state = {"n": 0}

    def bump():
        with lock:
            cur = state["n"]
        # the atomicity hole: another bumper can run here
        with lock:
            state["n"] = cur + 1

    ts = [threading.Thread(target=bump) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert state["n"] == 2, f"lost update: n={state['n']}"


def planted_deadlock() -> None:
    """Classic AB/BA inversion; the explorer must hit the interleaving
    where both threads hold one lock and want the other."""
    a = sanitizer.make_lock("fixture.a")
    b = sanitizer.make_lock("fixture.b")

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    ts = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


# -- protocol fixtures --------------------------------------------------------


def admission_preempt_vs_drain() -> None:
    """Three priority classes racing one slot + one queue spot while the
    main thread drains: every client must resolve (admit or shed, never
    hang), the bump arbitration must never lose a slot, and the drain
    must complete with zero active/waiting."""
    from llm_consensus_tpu_torch.serve.admission import (
        AdmissionController, RetryLater,
    )

    ac = AdmissionController(max_concurrency=1, max_queue=1, age_s=1e9)
    results: list = []

    def client(prio):
        try:
            t = ac.admit(priority=prio)
            results.append(("ok", prio))
            t.release()
        except RetryLater as e:
            results.append(("shed", prio, e.status))

    ts = [threading.Thread(target=client, args=(p,)) for p in (2, 1, 0)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    ac.begin_drain()
    assert ac.drain(timeout=5), "drain did not complete"
    snap = ac.snapshot()
    assert snap["active"] == 0 and snap["waiting"] == 0, snap
    assert snap["admitted"] + snap["rejected"] == 3, (snap, results)


def _stub_handoff(crash_wave):
    """A real KVHandoff wired over stubs: the queue/worker/submitter
    protocol is genuine (constructed through ``KVHandoff.__init__`` so
    the fixture can never drift from the real field layout), the tensor
    wave is replaced (crash injectable by wave number). Explicit
    depth/wave/wait kwargs keep knob resolution out of the schedule."""
    import torch

    from llm_consensus_tpu_torch.engine import handoff as ho

    class StubPool:
        block_size = 4

        def covers(self, ids):
            return False

    class StubCfg:
        name = "stub"

    class StubEngine:
        cfg = StubCfg()
        mesh = None
        device = torch.device("cpu")  # both roles on one device
        prefill_chunk = 0  # a handoff takes any prompt of one block
        _kv_pool = StubPool()  # decode side: the pool IS the channel

        def _resident(self):
            return None  # no tree of its own: the first wave copies one

    class StubWaveHandoff(ho.KVHandoff):
        def _wave(self, batch, wave_n):
            if wave_n == crash_wave:
                raise RuntimeError("injected prefill worker crash")
            for t in batch:
                t.resolve(True)

    return StubWaveHandoff(
        StubEngine(), StubEngine(),
        depth=2, wave_rows=1, wait_s=5.0, name="stub",
    )


def handoff_crash_fallback() -> None:
    """Three submitters against a depth-2 queue whose worker crashes at
    wave 2: every submitter must resolve (handed off, rejected-to-
    classic, or crash-fallback — never hang), the worker must survive
    the crashed wave, and close() must fail any stragglers."""
    h = _stub_handoff(crash_wave=2)
    outcomes: list = []

    def submitter(i):
        ok, _trunc = h.run(list(range(8)), priority=1)
        outcomes.append(ok)

    ts = [threading.Thread(target=submitter, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    h.close()
    assert len(outcomes) == 3, outcomes
    with h._lock:
        assert h.stats["submitted"] == 3, h.stats


def supervisor_restart_vs_submit() -> None:
    """Supervisor lifecycle vs concurrent restart notes and stat reads:
    the watchdog thread, a restart-noting thread, and a stats-polling
    thread interleave with close() — no hang, counts conserved."""
    from llm_consensus_tpu_torch.recovery.journal import StreamJournal
    from llm_consensus_tpu_torch.recovery.supervisor import EngineSupervisor

    class StubProvider:
        def _batcher_entries(self):
            return []

    # The supervisor holds its provider WEAKLY (a released provider must
    # not be pinned by the watchdog): keep a strong local reference for
    # the fixture's lifetime or the watchdog exits on its first pass and
    # the interleavings this fixture exists to explore never happen.
    provider = StubProvider()
    sup = EngineSupervisor(provider, StreamJournal(), heartbeat_s=0.1)

    def noter():
        sup.note_restart("p0")
        sup.note_restart("p1")

    def poller():
        for _ in range(3):
            sup.stats()

    ts = [threading.Thread(target=noter), threading.Thread(target=poller)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    st = sup.stats()
    sup.close()
    assert st["restarts"] == 2, st


def scale_down_vs_resident_stream() -> None:
    """Elastic scale-down racing a resident stream (serve/elastic.py):
    the migrator seals the stream's REAL journal entry and ships the
    snapshot into a MigrationTable while a decode worker is still
    appending chunks, a preemptor concurrently snapshots-and-retires the
    entry, and two claimers race the record. Invariants: the sealed
    snapshot is authoritative (every post-seal append is dropped, so the
    entry's final tokens equal the shipped snapshot exactly — the bytes
    the destination replays are the bytes the resume regenerates), the
    snapshot is never torn (the pre-seal prefix plus a prefix of the
    late chunks, in order), the record is claimed exactly once, and
    every thread resolves."""
    from llm_consensus_tpu_torch.recovery.journal import StreamJournal
    from llm_consensus_tpu_torch.serve.elastic import (
        MigrationRecord, MigrationTable,
    )

    journal = StreamJournal()
    entry = journal.record([1, 2, 3, 4], None, trace="trace-mig")
    entry.append(101)
    entry.append(102)
    table = MigrationTable(ttl_s=1e9, clock=lambda: 0.0)
    shipped: list = []
    claims: list = []

    def late_appender():
        # The decode worker racing the seal: each chunk either makes the
        # snapshot (and ships) or is dropped by the sealed entry (and is
        # regenerated deterministically by the resume) — never torn.
        entry.append(103)
        entry.append(104)

    def migrator():
        snap = entry.seal()
        table.offer(MigrationRecord(
            key="k1",
            resume={"m": {
                "prompt_ids": [1, 2, 3, 4],
                "sampling": {},
                "tokens": list(snap),
            }},
            priority=1,
            trace_id="trace-mig",
        ))
        shipped.append(snap)

    def preemptor():
        # Concurrent preemption: snapshots the frontier and retires the
        # entry — retirement must not corrupt the migrator's seal.
        entry.tokens()
        entry.close("preempted")

    def claimer():
        rec = table.claim("k1")
        if rec is not None:
            claims.append(rec)

    ts = [
        threading.Thread(target=late_appender),
        threading.Thread(target=migrator),
        threading.Thread(target=preemptor),
        threading.Thread(target=claimer),
        threading.Thread(target=claimer),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # A claimer that ran before the offer found nothing — the resumed
    # leader's claim happens strictly after the ship in the real
    # protocol, so sweep once more to model it.
    rec = table.claim("k1")
    if rec is not None:
        claims.append(rec)
    assert len(claims) == 1, f"claim-once violated: {len(claims)} claims"
    snap = shipped[0]
    assert claims[0].resume["m"]["tokens"] == snap, (claims, snap)
    # Authoritative seal: post-seal appends were dropped, so the entry's
    # final token state IS the shipped snapshot.
    assert entry.tokens() == snap, (entry.tokens(), snap)
    # Never torn: pre-seal prefix intact, late chunks a prefix, in order.
    assert snap[:2] == [101, 102], snap
    assert snap[2:] == [103, 104][: len(snap) - 2], snap


def swap_vs_resident_stream() -> None:
    """Live weight hot-swap racing resident streams (engine/engine.py).

    Runs the REAL Engine pin/swap methods on a swap-only stub (no model,
    no mesh — ``Engine.__new__`` plus exactly the state the hot-swap
    section owns, ``_flipping`` included: the flag that holds the
    batcher's admission gate from a flip until its cache hygiene is done),
    so the explorer preempts inside the actual lock discipline. Each
    weight buffer is a one-leaf tree on the CPU (the preparation's device
    copy is then the leaf itself, so a buffer keeps its identity). Two
    resident streams pin, decode (read ``params`` twice), and unpin; two
    swappers race the SAME target version with different buffers.
    Invariants: a stream's reads are consistent (the flip never lands
    under a pin, so both reads return one buffer and it is THE buffer of
    the pinned version), exactly one swapper wins (the loser is counted as
    a reject), and the accepted buffer is resident once the pins drain —
    never parked forever, never double-applied, and the admission gate
    open again."""
    import torch

    from llm_consensus_tpu_torch.engine.engine import Engine

    class _Cfg:
        name = "proto"

    def buffer(tag: float) -> dict:
        return {"layers": {"attn_norm": torch.full((1,), tag)}}

    def leaf(tree: dict):
        return tree["layers"]["attn_norm"]

    bufs = {"A": buffer(0.0), "B": buffer(1.0), "C": buffer(2.0)}
    eng = Engine.__new__(Engine)
    eng.cfg = _Cfg()
    eng.device = torch.device("cpu")
    eng._faults = None
    eng._groups = None
    eng.quant = None
    eng._kv_pool = None
    eng.params = bufs["A"]
    eng._layers = None
    eng._prefix_lock = sanitizer.make_lock("engine.prefix")
    eng._prefix_ids = None
    eng._prefix_cache = None
    eng._swap_lock = sanitizer.make_lock("engine.swap")
    eng._swap_cv = sanitizer.make_condition("engine.swap", eng._swap_lock)
    eng.weight_version = 0
    eng.weight_meta = {}
    eng._pins = 0
    eng._pending_swap = None
    eng._flipping = False
    eng._prev_weights = None
    eng._swap_requested = 0.0
    eng._swap_stats = {
        "swaps": 0, "swap_rejects": 0, "swap_queued": 0,
        "rollbacks": 0, "last_vacate_ms": 0.0, "last_prep_ms": 0.0,
    }

    observations: list = []
    accepted: list = []

    def resident():
        v = eng.pin_weights()
        seen = eng.params      # decode dispatch reads the resident buffer
        seen2 = eng.params     # ... and again, later in the same stream
        eng.unpin_weights()
        observations.append((v, seen, seen2))

    def swapper(name):
        if eng.swap_weights(1, bufs[name]):
            accepted.append(name)

    ts = [
        threading.Thread(target=resident),
        threading.Thread(target=resident),
        threading.Thread(target=swapper, args=("B",)),
        threading.Thread(target=swapper, args=("C",)),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # Exactly one swapper won the version race; the loser was rejected.
    assert len(accepted) == 1, f"accept-once violated: {accepted}"
    winner = accepted[0]
    st = eng.swap_stats()
    assert st["swaps"] == 1 and st["swap_rejects"] == 1, st
    # Pins drained ⇒ the accepted buffer is resident, nothing is parked,
    # and the flip's hygiene reopened the admission gate.
    assert st["pins"] == 0 and st["swap_pending"] == 0, st
    assert not eng.swap_pending(), "admission gate left shut"
    assert eng.weight_version == 1 and leaf(eng.params) is leaf(bufs[winner]), (
        eng.weight_version, winner,
    )
    by_version = {0: bufs["A"], 1: bufs[winner]}
    for v, seen, seen2 in observations:
        # No torn stream: both reads saw ONE buffer, and it is the
        # buffer of the version the stream pinned.
        assert seen is seen2, (v, seen, seen2)
        assert leaf(seen) is leaf(by_version[v]), (v, seen, by_version)


def quarantine_vs_resident_stream() -> None:
    """Integrity quarantine racing an in-flight resident stream and a
    concurrent retire (serve/gateway.py quarantine walk + the real
    integrity/core.py tracker). A striker drives integrity failures
    over the threshold; the quarantine walk and a concurrent retire
    walk both try to ship the SAME resident — serialized on the
    gateway's ship lock, modeled here — while the stream races to
    finish locally. Invariants: quarantine engages exactly once per
    threshold crossing; the resident is shipped and cancelled AT MOST
    once (never double-cancelled — the explorer found exactly this
    without the ship lock); and the client is never stranded: it holds
    the locally finished answer, or the destination holds a claimable
    record offered strictly BEFORE the cancel (a stream may legally do
    both — finish while a walk is mid-ship — and the late cancel is a
    no-op on a completed run, the stale parked record expiring by
    TTL)."""
    from llm_consensus_tpu_torch.integrity import QuarantineTracker
    from llm_consensus_tpu_torch.serve.elastic import (
        MigrationRecord, MigrationTable,
    )

    tracker = QuarantineTracker(threshold=2, probe_n=1)
    table = MigrationTable(ttl_s=1e9, clock=lambda: 0.0)
    ship_lock = sanitizer.make_lock("proto.quarantine.ship")
    state_lock = sanitizer.make_lock("proto.quarantine.state")
    state = {"migrated": False, "done": False}  # guarded by: state_lock
    engages: list = []
    cancels: list = []
    offered: list = []

    def ship() -> None:
        # The gateway's _ship_residents contract: serialize walks, skip
        # a resident another walk already shipped or that finished, and
        # cancel only AFTER the destination holds the record.
        with ship_lock:
            with state_lock:
                if state["migrated"] or state["done"]:
                    return
            rec = MigrationRecord(
                key="k1", resume={"m": {"text": ""}},
                priority=1, trace_id="trace-q",
            )
            rec.stamp_digest()
            table.offer(rec)
            offered.append(rec)
            with state_lock:
                state["migrated"] = True
            cancels.append(1)  # ctx.cancel(), after the offer

    def striker():
        # Two failures against threshold 2: the crossing fires the
        # quarantine walk exactly once, however the strikes interleave
        # with the other threads.
        for _ in range(2):
            if tracker.strike():
                engages.append(1)
                ship()

    def retirer():
        # A concurrent scale-down racing the quarantine over the same
        # resident set.
        ship()

    def finisher():
        # The in-flight stream completing normally: it unregisters
        # unless a walk already shipped it (then the cancel converts it
        # to StreamMigrated instead).
        with state_lock:
            if not state["migrated"]:
                state["done"] = True

    ts = [
        threading.Thread(target=striker),
        threading.Thread(target=retirer),
        threading.Thread(target=finisher),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(engages) == 1, f"quarantine engaged {len(engages)} times"
    assert len(cancels) <= 1, f"double-cancel: {len(cancels)}"
    assert state["migrated"] or state["done"], state  # never stranded
    rec = table.claim("k1")
    if state["migrated"]:
        # Shipped ⇒ cancelled exactly once, record intact and claimable
        # exactly once — the stream resumes on the destination (or, if
        # it also finished locally mid-ship, the record is stale and
        # the cancel was a no-op; either way nothing is lost).
        assert len(cancels) == 1 and len(offered) == 1, (cancels, offered)
        assert rec is not None and rec.verify_digest(), rec
        assert table.claim("k1") is None  # claim-once
    else:
        # Finished locally before any walk reached it: never cancelled,
        # nothing parked anywhere.
        assert not cancels and rec is None, (cancels, rec)


PROTOCOLS = {
    "admission-preempt-vs-drain": admission_preempt_vs_drain,
    "handoff-crash-fallback": handoff_crash_fallback,
    "supervisor-restart-vs-submit": supervisor_restart_vs_submit,
    "scale-down-vs-resident-stream": scale_down_vs_resident_stream,
    "swap-vs-resident-stream": swap_vs_resident_stream,
    "quarantine-vs-resident-stream": quarantine_vs_resident_stream,
}

PLANTED = {
    "planted-atomicity": planted_atomicity,
    "planted-deadlock": planted_deadlock,
}

__all__ = [
    "PROTOCOLS", "PLANTED", "planted_atomicity", "planted_deadlock",
    "admission_preempt_vs_drain", "handoff_crash_fallback",
    "supervisor_restart_vs_submit", "scale_down_vs_resident_stream",
    "swap_vs_resident_stream", "quarantine_vs_resident_stream",
]
