"""FastTrack-style vector-clock happens-before race detection.

The sanitizer proves lock *placement* (static ``GS``) and lock
*ordering* (runtime cycle graph); this module closes the remaining gap:
**ordering races on guarded state** — a read and a write of the same
field with no happens-before edge between them, which no lock-order
cycle reveals and which the static checker cannot see when one access
hides behind a helper or an annotated-deliberate path goes stale.

The guarded-state checker's **static field inventory is the dynamic
instrumentation point set**: :func:`inventory` re-runs the ``GS`` scan
(pure AST, cached) over the package, and :func:`attach` wraps each
inventoried class's ``__getattribute__`` / ``__setattr__`` so every
rebind (write) and load (read) of a ``# guarded by:`` field reports to
the detector. Granularity note: container *mutations*
(``self._queue.append``) surface as reads of the field binding — two
off-lock mutators therefore need the schedule explorer's invariant
fixtures, while scalar read/write races (the ``+=`` lost-update class
and torn multi-field invariants) are caught here directly.

Happens-before edges come from the sanitizer seam: lock release ⇒ later
acquire (FastTrack's lock clocks), explicit notify ⇒ wake on conditions
and set ⇒ wait-return on events (the sanitizer's wait/notify
bookkeeping), and thread fork/join from the cooperative scheduler. Epochs keep
the common same-thread path O(1); a read set promotes to a full vector
clock only when genuinely shared (the FastTrack adaptive
representation).

False-positive discipline: an access whose source line carries
``# lint-ok: GS01`` (the deliberate lock-free reads the static checker
already documents) or ``# race-ok`` is excluded at report time — the
safety argument stays inline, shared by both analyses. Races accumulate
in :attr:`RaceDetector.races`; a schedule session raises
:class:`RaceError` at exit so the first racy interleaving fails with
both access sites in hand.
"""

from __future__ import annotations

import linecache
import sys
import threading
import weakref
from pathlib import Path
from typing import Callable, Iterable, Optional


class RaceError(AssertionError):
    """One or more happens-before races on guarded fields."""

    def __init__(self, races: list):
        self.races = list(races)
        lines = []
        for r in self.races[:8]:
            lines.append(
                f"  {r['kind']} race on {r['label']}: "
                f"{r['prev_site'][0]}:{r['prev_site'][1]} vs "
                f"{r['site'][0]}:{r['site'][1]}"
            )
        more = len(self.races) - len(lines)
        if more > 0:
            lines.append(f"  … and {more} more")
        super().__init__(
            f"{len(self.races)} happens-before race(s) on guarded fields\n"
            + "\n".join(lines)
        )


class _Var:
    """Per-(object, field) access state: write epoch + adaptive reads."""

    __slots__ = (
        "wt", "wc", "wsite", "rt", "rc", "rsite", "rvc", "rsites",
    )

    def __init__(self):
        self.wt = None
        self.wc = 0
        self.wsite = None
        self.rt = None
        self.rc = 0
        self.rsite = None
        self.rvc = None
        self.rsites = None


def _suppressed(site) -> bool:
    line = linecache.getline(site[0], site[1])
    return "race-ok" in line or ("lint-ok:" in line and "GS01" in line)


class RaceDetector:
    """Process-wide happens-before state: per-thread vector clocks,
    per-sync-object clocks, per-variable epochs. Thread identity comes
    from ``tid_fn`` — the cooperative scheduler's stable tids inside a
    schedule session (idents recycle, tids don't), ``get_ident``
    otherwise. All hooks are cheap no-ops for threads ``tid_fn`` does
    not know (returns None): uncontrolled helper threads never
    corrupt the clock space."""

    def __init__(self, tid_fn: Optional[Callable] = None):
        self._mu = threading.Lock()
        self.tid_fn = tid_fn or threading.get_ident
        self._clocks: dict = {}   # tid -> {tid: int}
        self._locks: dict = {}    # lock id -> clock
        self._sync: dict = {}     # cond/event id -> accumulated clock
        self._vars: dict = {}     # (obj id, field) -> _Var
        self._tracked: dict = {}  # obj id -> weakref.finalize (or None)
        self._dead: list = []     # collected obj ids awaiting purge
        self._seen: set = set()
        self.races: list = []

    # -- object-identity hygiene ----------------------------------------------
    #
    # ``id(obj)`` recycles: epochs of a COLLECTED object must not alias
    # onto a new object allocated at the same address (a dead thread's
    # stale write epoch would false-positive the new object's first
    # properly-locked access). A ``weakref.finalize`` per tracked object
    # queues its id for purge — append-only from the finalizer (which
    # may fire mid-GC while THIS thread holds ``_mu``; taking the lock
    # there would self-deadlock), drained under ``_mu`` on the next
    # access before the id can be re-observed.

    def _track_locked(self, obj, oid) -> None:
        if oid in self._tracked:
            return
        try:
            fin = weakref.finalize(obj, self._dead.append, oid)
        except TypeError:
            fin = None  # not weakref-able: entries live for the session
        self._tracked[oid] = fin

    def _purge_dead_locked(self) -> None:
        dead = set()
        while self._dead:
            dead.add(self._dead.pop())
        for oid in dead:
            self._tracked.pop(oid, None)
        for key in [k for k in self._vars if k[0] in dead]:
            del self._vars[key]

    # -- clock helpers --------------------------------------------------------

    def _ct(self, t) -> dict:
        c = self._clocks.get(t)
        if c is None:
            c = self._clocks[t] = {t: 1}
        return c

    @staticmethod
    def _join(dst: dict, src: dict) -> None:
        for k, v in src.items():
            if v > dst.get(k, 0):
                dst[k] = v

    # -- sync edges -----------------------------------------------------------

    def on_acquire(self, t, m) -> None:
        if t is None:
            return
        with self._mu:
            lm = self._locks.get(m)
            if lm:
                self._join(self._ct(t), lm)

    def on_release(self, t, m) -> None:
        if t is None:
            return
        with self._mu:
            c = self._ct(t)
            self._locks[m] = dict(c)
            c[t] = c.get(t, 0) + 1

    def on_notify(self, t, s) -> None:
        if t is None:
            return
        with self._mu:
            c = self._ct(t)
            acc = self._sync.setdefault(s, {})
            self._join(acc, c)
            c[t] = c.get(t, 0) + 1

    def on_wake(self, t, s) -> None:
        if t is None:
            return
        with self._mu:
            acc = self._sync.get(s)
            if acc:
                self._join(self._ct(t), acc)

    def on_fork(self, parent, child) -> None:
        with self._mu:
            pc = self._ct(parent)
            cc = dict(pc)
            cc[child] = 1
            self._clocks[child] = cc
            pc[parent] = pc.get(parent, 0) + 1

    def on_join(self, parent, child) -> None:
        with self._mu:
            cc = self._clocks.get(child)
            if cc:
                self._join(self._ct(parent), cc)

    def on_thread_end(self, t) -> None:
        # The final clock stays in _clocks for a later on_join.
        pass

    # -- variable accesses ----------------------------------------------------

    def _race(self, kind, label, prev_site, site) -> None:
        if prev_site is None or site is None:
            return
        if _suppressed(prev_site) or _suppressed(site):
            return
        key = (kind, label, prev_site, site)
        if key in self._seen:
            return
        self._seen.add(key)
        self.races.append({
            "kind": kind,
            "label": label,
            "prev_site": prev_site,
            "site": site,
        })

    def on_read(self, obj, field: str, site, label: str) -> None:
        t = self.tid_fn()
        if t is None:
            return
        with self._mu:
            if self._dead:
                self._purge_dead_locked()
            c = self._ct(t)
            oid = id(obj)
            v = self._vars.get((oid, field))
            if v is None:
                self._track_locked(obj, oid)
                v = self._vars[(oid, field)] = _Var()
            if v.wt is not None and v.wt != t and v.wc > c.get(v.wt, 0):
                self._race("write-read", label, v.wsite, site)
            if v.rvc is not None:
                v.rvc[t] = c.get(t, 0)
                v.rsites[t] = site
            elif v.rt is None or v.rt == t or v.rc <= c.get(v.rt, 0):
                v.rt, v.rc, v.rsite = t, c.get(t, 0), site
            else:
                v.rvc = {v.rt: v.rc, t: c.get(t, 0)}
                v.rsites = {v.rt: v.rsite, t: site}
                v.rt = None

    def on_write(self, obj, field: str, site, label: str) -> None:
        t = self.tid_fn()
        if t is None:
            return
        with self._mu:
            if self._dead:
                self._purge_dead_locked()
            c = self._ct(t)
            oid = id(obj)
            v = self._vars.get((oid, field))
            if v is None:
                self._track_locked(obj, oid)
                v = self._vars[(oid, field)] = _Var()
            if v.wt is not None and v.wt != t and v.wc > c.get(v.wt, 0):
                self._race("write-write", label, v.wsite, site)
            if v.rvc is not None:
                for u, rc in v.rvc.items():
                    if u != t and rc > c.get(u, 0):
                        self._race(
                            "read-write", label, v.rsites.get(u), site
                        )
                        break
            elif v.rt is not None and v.rt != t and v.rc > c.get(v.rt, 0):
                self._race("read-write", label, v.rsite, site)
            v.wt, v.wc, v.wsite = t, c.get(t, 0), site
            v.rt, v.rc, v.rsite = None, 0, None
            v.rvc = None
            v.rsites = None


# -- guarded-field inventory (the GS scan, reused dynamically) ----------------

_inventory_cache: Optional[dict] = None


def inventory() -> dict:
    """{(module_name, class_name): {field, …}} for every class the
    guarded-state checker sees — computed from source (pure AST), so
    the dynamic point set can never drift from the static one."""
    global _inventory_cache
    if _inventory_cache is not None:
        return _inventory_cache
    import ast

    from llm_consensus_tpu_torch.analysis.core import Project
    from llm_consensus_tpu_torch.analysis.guarded_state import _scan_init

    import llm_consensus_tpu_torch

    root = Path(llm_consensus_tpu_torch.__file__).resolve().parent.parent
    out: dict = {}
    try:
        project = Project(root)
    except FileNotFoundError:
        _inventory_cache = out
        return out
    for pf in project.package_files():
        tree = pf.tree
        if tree is None:
            continue
        mod = pf.relpath[:-3].replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            info = _scan_init(pf, cls)
            if info is None:
                continue
            out[(mod, cls.name)] = set(info.guarded)
    _inventory_cache = out
    return out


# -- class instrumentation ----------------------------------------------------

_detector: Optional[RaceDetector] = None
_instrumented: dict = {}  # cls -> (orig __getattribute__, orig __setattr__)


def detector() -> Optional[RaceDetector]:
    return _detector


def instrument_class(cls, fields: Iterable) -> None:
    """Wrap ``cls`` so accesses of ``fields`` report to the attached
    detector (fast-path: one set lookup + one global None-check when
    detached). Idempotent; :func:`detach` restores the originals."""
    if cls in _instrumented:
        return
    fieldset = frozenset(fields)
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__
    cls_name = cls.__name__

    def __getattribute__(self, name):
        if name in fieldset:
            det = _detector
            if det is not None:
                fr = sys._getframe(1)
                det.on_read(
                    self, name, (fr.f_code.co_filename, fr.f_lineno),
                    f"{cls_name}.{name}",
                )
        return orig_get(self, name)

    def __setattr__(self, name, value):
        if name in fieldset:
            det = _detector
            if det is not None:
                fr = sys._getframe(1)
                det.on_write(
                    self, name, (fr.f_code.co_filename, fr.f_lineno),
                    f"{cls_name}.{name}",
                )
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__
    cls.__setattr__ = __setattr__
    _instrumented[cls] = (orig_get, orig_set)


def attach(det: RaceDetector, extra: Iterable = ()) -> None:
    """Install ``det`` as the process detector and instrument every
    already-imported inventoried class (plus ``extra``: an iterable of
    ``(cls, fields)`` pairs for harness-local fixture classes)."""
    import importlib

    from llm_consensus_tpu_torch.analysis import sanitizer

    global _detector
    for (mod, cls_name), fields in inventory().items():
        m = sys.modules.get(mod)
        if m is None:
            # A fixture that lazy-imports its subject module must not
            # run its first schedule uninstrumented: import the
            # inventoried module now (skip ones whose deps are absent).
            try:
                m = importlib.import_module(mod)
            except Exception:  # noqa: BLE001 — optional heavy deps
                continue
        cls = getattr(m, cls_name, None)
        if isinstance(cls, type):
            instrument_class(cls, fields)
    for cls, fields in extra:
        instrument_class(cls, fields)
    _detector = det
    sanitizer.set_race_detector(det)


def detach() -> None:
    """Remove the detector and restore every instrumented class."""
    from llm_consensus_tpu_torch.analysis import sanitizer

    global _detector
    _detector = None
    sanitizer.set_race_detector(None)
    for cls, (orig_get, orig_set) in _instrumented.items():
        cls.__getattribute__ = orig_get
        cls.__setattr__ = orig_set
    _instrumented.clear()


__all__ = [
    "RaceDetector", "RaceError", "inventory", "instrument_class",
    "attach", "detach", "detector",
]
