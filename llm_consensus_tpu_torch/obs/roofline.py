"""Per-family roofline attribution: why does this family run at its rate?
(the port of ``llm_consensus_tpu/obs/roofline.py``).

The attribution ledger (obs/attrib.py) says where device seconds go; this
module joins them with the work each family did: achieved FLOP/s and
bytes/s, arithmetic intensity (FLOPs per byte) and a compute- or
memory-bound verdict against the card's ridge (peak FLOP/s over peak
bytes/s from ``utils/flops.device_peaks`` by the card's name; 32 off the
card; ``LLMC_ROOFLINE_RIDGE`` pins it).

**Counting the work without XLA.** The JAX ledger takes XLA's cost
analysis of the lowered program once per ``(family, bucket-shape)`` key.
The port counts instead: the first dispatch of a key runs one step under
:class:`WorkCounter`, a ``TorchDispatchMode`` that sees every aten op.

  * FLOPs come from ``torch.utils.flop_counter``'s formulas (matrix
    products and attention); ``matmul`` (which reaches the mode whole
    under inference mode) and ``_int_mm`` count their 2·M·K·N operations.
  * Bytes are each op's tensor inputs plus outputs, the "operands +
    outputs" convention of the JAX capture. Views move nothing; a gather or
    an index read counts its indices and twice its output (XLA's gather
    rule: not the whole table); an in-place update counts what it reads
    and the bytes it writes, not the whole tensor it writes into.
  * The hand-written kernels are ``ctypes`` launches the mode cannot see.
    While a capture is live on its thread each kernel wrapper adds its own
    work (``Capture.kernel``: the counts ``chip_smoke.py`` bounds with,
    valid cache slots only) and its plain version, on the CPU, is not
    counted again.
  * Only the first layer of the step is counted: the forward enters
    :meth:`Capture.layer` around each layer, the first counts and the
    others run outside the mode, and the capture adds the first layer's
    work once more for each of them (every layer runs the same ops on the
    same shapes). A decode chunk is a host loop of one-token steps: one
    step is counted and the key's totals multiply by each dispatch's
    ``steps``, as the JAX ``steps`` multiplier does for a scan body.

A capture costs the host a few milliseconds once per key, on the dispatch
path: the mode's Python runs for every op of the counted layer and of the
step around the layers. That time (:func:`held_s`) is taken out of the
dispatch's stream interval (obs/attrib.py ``DeviceWall``), so a
captured dispatch books what an uncaptured one of its key books.

Later dispatches of a key bump counters only. ``source`` reads
``dispatch``, not ``xla``; the document keeps the JAX keys
(``flops_per_token_xla`` and the rest) so that a reader of either
package's ``metrics.json`` finds the same fields.

Cross-check: engines register their analytic per-token costs
(:meth:`RooflineLedger.note_modeled`, utils/flops.py) and the snapshot
holds the counted FLOPs per token against that range (``tol``).

The ledger is installed by the CLI (``LLMC_ROOFLINE``: "0" off, unset
follows attribution; ``LLMC_ROOFLINE_RIDGE``, ``LLMC_ROOFLINE_TOL``) and
bound by the engines at construction; :func:`ledger` is None when nothing
is installed.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry

from llm_consensus_tpu_torch.analysis import sanitizer

DEFAULT_RIDGE = 32.0
DEFAULT_TOL = 4.0

# Live captures in the process: the kernel wrappers' one-read check on
# every call (a capture itself is per thread, in _tls).
CAPTURING = 0
_capturing_lock = sanitizer.make_lock("obs.roofline.capturing")
_tls = threading.local()

_aten = torch.ops.aten
_aten_device = torch.ops.prim.device.default
# Ops that move no bytes: allocation without a write, metadata.
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.lift_fresh.default,
}
# Tensor operands of the matrix products' flop formulas.
_PRODUCT_OPERANDS = {_aten.mm: 2, _aten.bmm: 2, _aten.addmm: 3, _aten.baddbmm: 3}
# Ops counted whole, without asking for a decomposition: learned as
# captures meet them, and ``matmul``, whose decomposition is Python (and
# imports sympy the first time a process runs it).
_ATOMIC: set = {_aten.matmul.default}
# Gathers: indices plus twice the output, not the whole source table.
_GATHERS = {_aten.index.Tensor, _aten.gather.default, _aten.index_select.default,
            _aten.embedding.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The distinct tensors of nested args, in order (a hand walk: pytree
    costs more than the rest of a capture's per-op work)."""
    seen, out, stack = set(), [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


class WorkCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op dispatched under it on
    this thread (see the module docstring for the conventions); kernel
    wrappers add their own work and pause it around their plain version.
    ``held_s`` is the host time the counting itself took: the mode's own
    code around each op, not the ops."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Nothing here is compiled: no dynamo guard around each op (its
        # first use imports torch._dynamo, seconds of host time).
        return False

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.out_bytes = 0.0
        self.paused = 0
        self.held_s = 0.0
        self._op_s = 0.0
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        t0 = time.perf_counter()
        op_s0 = self._op_s
        self._depth += 1
        try:
            return self._dispatch(func, args, kwargs or {})
        finally:
            self._depth -= 1
            if not self._depth:
                self.held_s += time.perf_counter() - t0 - (self._op_s - op_s0)

    def _dispatch(self, func, args, kwargs):
        # A composite op is counted as the ops it decomposes into, as
        # torch's FlopCounterMode does; an op found to have no
        # decomposition is not asked again.
        if func not in _ATOMIC and func is not _aten_device:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _ATOMIC.add(func)
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        self._op_s += time.perf_counter() - t0
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            # A matrix product's formula takes its tensor operands alone:
            # the ``.dtype`` overloads' out_dtype would land on out_shape.
            n = _PRODUCT_OPERANDS.get(packet)
            if n is not None:
                args, kwargs = args[:n], {}
            self.flops += float(formula(*args, **kwargs, out_val=out))
        elif packet is _aten.matmul:
            self.flops += 2.0 * out.numel() * args[0].shape[-1]
        elif packet is _aten._int_mm:
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops += 2.0 * m * k * n
        if func.is_view or func in _NO_TRAFFIC:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        out_b = float(sum(_nbytes(t) for t in outs))
        if func in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:])
            self.bytes += idx + 2.0 * out_b
            self.out_bytes += out_b
        elif func._schema.is_mutable and ins:
            # An in-place update writes what it reads from its sources
            # (a copy_, an index_copy_), or rewrites self (clamp_).
            srcs = [_nbytes(t) for t in ins[1:]]
            written = max(srcs) if srcs else _nbytes(ins[0])
            self.bytes += sum(srcs) + written + (0 if srcs else _nbytes(ins[0]))
            self.out_bytes += written
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + out_b
            self.out_bytes += out_b


class Capture:
    """One dispatch counted under a :class:`WorkCounter` (a context manager
    the dispatch site enters around ONE step of the dispatch, handing
    :meth:`layer` to the forward). ``kv_valid`` is the host-known number of
    valid cache slots the decode kernel reads in that step, summed over
    rows (None: every slot of the width)."""

    def __init__(self, ledger: "RooflineLedger", pkey: tuple, tokens: int, steps: int,
                 kv_valid: Optional[int] = None) -> None:
        self._ledger = ledger
        self._pkey = pkey
        self._tokens = tokens
        self._steps = steps
        self.kv_valid = kv_valid
        self.n_layers = 0
        self._layer_work = (0.0, 0.0, 0.0)
        self._mode = WorkCounter()

    def __enter__(self) -> "Capture":
        global CAPTURING
        with _capturing_lock:
            CAPTURING += 1
        _tls.capture = self
        self._mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global CAPTURING
        self._mode.__exit__(exc_type, exc, tb)
        _tls.capture = None
        with _capturing_lock:
            CAPTURING -= 1
        m = self._mode
        _tls.held_s = held_s() + m.held_s
        # Every layer after the first did the first one's work.
        more = max(0, self.n_layers - 1)
        flops, nbytes, out_b = (
            total + more * layer for total, layer in
            zip((m.flops, m.bytes, m.out_bytes), self._layer_work))
        counted = exc_type is None and (flops > 0 or nbytes > 0)
        raw = {"raw_flops": flops if counted else 0.0,
               "raw_bytes": nbytes if counted else 0.0,
               "raw_out_bytes": out_b if counted else 0.0,
               "source": "dispatch" if counted else "none"}
        self._ledger._captured(self._pkey, raw, self._tokens, self._steps, m.held_s)

    @contextmanager
    def layer(self, i: int):
        """Layer ``i`` of the counted step: the first is counted, the
        others run outside the mode (and outside the kernel wrappers'
        bookkeeping) and are booked as copies of the first at exit."""
        self.n_layers = max(self.n_layers, i + 1)
        m = self._mode
        if i == 0:
            before = (m.flops, m.bytes, m.out_bytes)
            yield
            self._layer_work = (m.flops - before[0], m.bytes - before[1],
                                m.out_bytes - before[2])
            return
        _tls.capture = None
        try:
            with _disable_current_modes():
                yield
        finally:
            _tls.capture = self

    @contextmanager
    def kernel(self, flops: float, nbytes: float, out_bytes: float = 0.0):
        """A hand-written kernel's own work; the ops inside (its plain
        version on the CPU) are not counted again."""
        m = self._mode
        m.flops += flops
        m.bytes += nbytes
        m.out_bytes += out_bytes
        m.paused += 1
        try:
            yield
        finally:
            m.paused -= 1


def current_capture() -> Optional[Capture]:
    """This thread's live capture, or None."""
    return getattr(_tls, "capture", None)


def held_s() -> float:
    """Host seconds this thread's captures have spent counting so far: a
    dispatch's stream interval drops what its capture added."""
    return getattr(_tls, "held_s", 0.0)


class RooflineLedger:
    """Counted work per (family, key) x the attribution walls. One lock
    serializes the counters; a key's one-time capture runs outside it,
    behind an in-progress marker, so concurrent first dispatches of one
    key count once (the others' counts are deferred into it)."""

    def __init__(self, ridge: float = 0.0, tol: float = DEFAULT_TOL):
        self.ridge_override = ridge if ridge and ridge > 0 else None
        self.fallback_ridge = DEFAULT_RIDGE
        self.tol = max(1.0, tol)
        self._lock = sanitizer.make_lock("obs.roofline")
        self._programs: dict = {}
        self._capturing: set = set()
        self._deferred: dict = {}
        self._modeled_fpt: dict = {}
        self._modeled_bpt: dict = {}
        # Bytes no dispatch counts: the disaggregated handoff's staged
        # spans (the kv_handoff family's traffic).
        self._transfer_bytes: dict = {}
        self._peaks_resolved = False
        self._peak_flops: Optional[float] = None
        self._peak_bw: Optional[float] = None
        self._n_devices = 1
        # Host seconds captures spent counting (the one-time cost per key).
        self.captures = 0
        self.capture_s = 0.0

    def dispatch(self, family: str, key: tuple, tokens: int = 0, steps: int = 1,
                 kv_valid: Optional[int] = None) -> Optional[Capture]:
        """Book one dispatch of ``(family, key)`` advancing ``tokens`` in
        ``steps`` steps. Returns a :class:`Capture` the caller runs one step
        of the dispatch under when the key has no counted cost yet, else
        None."""
        pkey = (family, key)
        with self._lock:
            rec = self._programs.get(pkey)
            if rec is not None:
                rec["dispatches"] += 1
                rec["steps"] += steps
                rec["tokens"] += tokens
                return None
            if pkey in self._capturing:
                d = self._deferred.setdefault(pkey, [0, 0, 0])
                d[0] += 1
                d[1] += steps
                d[2] += tokens
                return None
            self._capturing.add(pkey)
        return Capture(self, pkey, tokens, max(1, steps), kv_valid)

    def _captured(self, pkey: tuple, raw: dict, tokens: int, steps: int, seconds: float) -> None:
        with self._lock:
            self._capturing.discard(pkey)
            deferred = self._deferred.pop(pkey, (0, 0, 0))
            rec = self._programs.setdefault(pkey, {"dispatches": 0, "steps": 0, "tokens": 0, **raw})
            rec["dispatches"] += 1 + deferred[0]
            rec["steps"] += steps + deferred[1]
            rec["tokens"] += tokens + deferred[2]
            self.captures += 1
            self.capture_s += seconds

    def note_transfer(self, family: str, nbytes: float) -> None:
        """Book transfer bytes no capture counts (the KV handoff's staged
        spans, engine/handoff.py)."""
        if nbytes <= 0:
            return
        with self._lock:
            self._transfer_bytes[family] = self._transfer_bytes.get(family, 0.0) + float(nbytes)

    def note_modeled(self, family: str, flops_per_token: float,
                     bytes_per_token: Optional[float] = None) -> None:
        """Register an engine's analytic per-token costs for ``family``;
        several engines widen the accepted range."""
        with self._lock:
            for table, v in ((self._modeled_fpt, flops_per_token),
                             (self._modeled_bpt, bytes_per_token)):
                if v and v > 0:
                    lo, hi = table.get(family, (v, v))
                    table[family] = (min(lo, v), max(hi, v))

    def _peaks(self) -> "tuple[Optional[float], Optional[float], int]":
        """(peak FLOP/s, peak bytes/s, device count) of the card, or Nones
        off it; resolved once CUDA is up."""
        if not self._peaks_resolved:
            from llm_consensus_tpu_torch.utils.flops import device_peaks

            peaks, n_dev = None, 1
            resolved = not torch.cuda.is_available()
            if not resolved and torch.cuda.is_initialized():
                peaks = device_peaks(torch.cuda.get_device_name(0))
                n_dev = max(1, torch.cuda.device_count())
                resolved = True
            with self._lock:
                self._peak_flops, self._peak_bw = peaks if peaks else (None, None)
                self._n_devices = n_dev
                self._peaks_resolved = resolved
        return self._peak_flops, self._peak_bw, self._n_devices

    def ridge(self) -> "tuple[float, str]":
        """(FLOPs-per-byte balance point, its provenance)."""
        if self.ridge_override is not None:
            return self.ridge_override, "override"
        peak_f, peak_b, _ = self._peaks()
        if peak_f and peak_b:
            return peak_f / peak_b, "device"
        return self.fallback_ridge, "default"

    def activity(self) -> int:
        with self._lock:
            return sum(r["dispatches"] for r in self._programs.values())

    def snapshot(self, device_s: Optional[dict] = None) -> dict:
        """The ``roofline`` block of ``metrics.json``: counted work per
        family joined with the attribution walls (``device_s``; read from
        the installed attribution ledger when omitted), verdicts, coverage
        and the cross-check."""
        if device_s is None:
            device_s = _attrib_walls()
        ridge, ridge_source = self.ridge()
        peak_f, peak_b, n_dev = self._peaks()
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            transfer = dict(self._transfer_bytes)
            modeled_fpt = dict(self._modeled_fpt)
            modeled_bpt = dict(self._modeled_bpt)
        fams: dict = {}
        for (family, _key), rec in sorted(programs.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            f = fams.setdefault(family, {"programs": 0, "dispatches": 0, "tokens": 0,
                                         "flops": 0.0, "bytes": 0.0, "out_bytes": 0.0,
                                         "sources": set()})
            f["programs"] += 1
            f["dispatches"] += rec["dispatches"]
            f["tokens"] += rec["tokens"]
            f["flops"] += rec["raw_flops"] * rec["steps"]
            f["bytes"] += rec["raw_bytes"] * rec["steps"]
            f["out_bytes"] += rec["raw_out_bytes"] * rec["steps"]
            f["sources"].add(rec["source"])
        for family, nbytes in transfer.items():
            f = fams.setdefault(family, {"programs": 0, "dispatches": 0, "tokens": 0,
                                         "flops": 0.0, "bytes": 0.0, "out_bytes": 0.0,
                                         "sources": set()})
            f["bytes"] += nbytes
            f["sources"].add("transfer")
        out_families: dict = {}
        covered_wall = 0.0
        for family, f in fams.items():
            wall = float((device_s or {}).get(family, 0.0))
            if f["dispatches"] > 0 and wall > 0:
                covered_wall += wall
            intensity = f["flops"] / f["bytes"] if f["bytes"] > 0 else None
            verdict = None
            if intensity is not None:
                verdict = "memory_bound" if intensity < ridge else "compute_bound"
            entry = {
                "programs": f["programs"],
                "dispatches": f["dispatches"],
                "tokens": f["tokens"],
                "flops": f["flops"],
                "bytes": f["bytes"],
                "out_bytes": f["out_bytes"],
                "wall_s": round(wall, 4),
                "achieved_flops_per_s": f["flops"] / wall if wall > 0 else None,
                "achieved_bytes_per_s": f["bytes"] / wall if wall > 0 else None,
                "intensity": intensity,
                "verdict": verdict,
                "source": "+".join(sorted(f["sources"])) or "none",
            }
            if peak_f and wall > 0:
                entry["mfu_vs_peak"] = f["flops"] / wall / (peak_f * n_dev)
            if peak_b and wall > 0:
                entry["mbu_vs_peak"] = f["bytes"] / wall / (peak_b * n_dev)
            out_families[family] = entry
        total_wall = sum(float(v) for v in (device_s or {}).values())
        crosscheck: dict = {}
        for family, (lo, hi) in sorted(modeled_fpt.items()):
            f = fams.get(family)
            if not f or f["tokens"] <= 0 or f["flops"] <= 0:
                continue
            measured = f["flops"] / f["tokens"]
            ratio = measured / hi if measured > hi else (measured / lo if measured < lo else 1.0)
            entry = {
                "flops_per_token_xla": measured,
                "flops_per_token_modeled": [lo, hi],
                "ratio": round(ratio, 4),
                "ok": (1.0 / self.tol) <= ratio <= self.tol,
            }
            b = modeled_bpt.get(family)
            if b is not None and f["bytes"] > 0:
                entry["bytes_per_token_xla"] = f["bytes"] / f["tokens"]
                entry["bytes_per_token_modeled"] = list(b)
            crosscheck[family] = entry
        return {
            "ridge_flops_per_byte": round(ridge, 4),
            "ridge_source": ridge_source,
            "peak_flops_per_s": peak_f,
            "peak_bytes_per_s": peak_b,
            "n_devices": n_dev,
            "families": {k: _round_floats(v) for k, v in sorted(out_families.items())},
            "coverage": {
                "covered_wall_s": round(covered_wall, 4),
                "attrib_wall_s": round(total_wall, 4),
                "fraction": round(covered_wall / total_wall, 4) if total_wall > 0 else None,
            },
            "crosscheck": {k: _round_floats(v) for k, v in crosscheck.items()},
            "tol": self.tol,
        }

    def prom_families(self, device_s: Optional[dict] = None) -> dict:
        """The ``llmc_roofline_*`` families ``/metricsz`` renders: FLOP,
        byte, dispatch and token totals per family as counters, and the
        ridge as a gauge (the JAX ledger's names and labels)."""
        snap = self.snapshot(device_s)
        flops, nbytes, disp, toks = [], [], [], []
        for family, f in snap["families"].items():
            flops.append(({"family": family}, f["flops"]))
            nbytes.append(({"family": family}, f["bytes"]))
            disp.append(({"family": family}, f["dispatches"]))
            if f["tokens"]:
                toks.append(({"family": family}, f["tokens"]))
        return {
            "roofline_flops_total": {"type": "counter", "samples": flops},
            "roofline_bytes_total": {"type": "counter", "samples": nbytes},
            "roofline_dispatches_total": {"type": "counter", "samples": disp},
            "roofline_tokens_total": {"type": "counter", "samples": toks},
            "roofline_ridge_flops_per_byte": {
                "type": "gauge",
                "samples": [({"source": snap["ridge_source"]}, snap["ridge_flops_per_byte"])],
            },
        }

    def counter_track(self) -> "list[tuple[str, float]]":
        """(counter name, value) pairs for the trace's roofline counter
        tracks (obs/export.py ``ph: "C"`` events)."""
        out = []
        for family, f in self.snapshot()["families"].items():
            out.append((f"roofline_flops/{family}", f["flops"]))
            out.append((f"roofline_bytes/{family}", f["bytes"]))
        return out


def _attrib_walls() -> dict:
    from llm_consensus_tpu_torch.obs import attrib

    led = attrib.ledger()
    return led.snapshot()["device_s"] if led is not None else {}


def _round_floats(doc: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) and abs(v) < 1e6 else v)
            for k, v in doc.items()}


_lock = sanitizer.make_lock("obs.roofline.registry")
_ledger: Optional[RooflineLedger] = None
_resolved = False


def ledger() -> Optional[RooflineLedger]:
    """The installed roofline ledger, or None."""
    return _ledger


def resolved() -> bool:
    return _resolved


def install(led: Optional[RooflineLedger]) -> None:
    global _ledger, _resolved
    with _lock:
        _ledger = led
        _resolved = True


def reset() -> None:
    global _ledger, _resolved
    with _lock:
        _ledger = None
        _resolved = False


__all__ = [
    "CAPTURING", "Capture", "DEFAULT_RIDGE", "DEFAULT_TOL", "RooflineLedger", "WorkCounter",
    "current_capture", "held_s", "install", "ledger", "reset", "resolved",
]
