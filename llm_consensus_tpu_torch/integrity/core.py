"""Integrity primitives: checksums, digests, counters, the plane (port of
``llm_consensus_tpu/integrity/core.py``).

Two checksum tiers, chosen by what they protect:

  * :func:`crc32c`: CRC32C (Castagnoli), table-driven pure Python. It
    frames ``StreamJournal`` WAL records: the records are short lines, and
    the polynomial is the storage standard for exactly this torn-write case.
  * :func:`digest_bytes`: ``zlib.crc32`` (C speed) for bulk content such as
    parameter trees, over host copies of the bytes.

Digests are hex strings (stable across processes, JSON-safe). The same
bytes give the same CRC32C, WAL frame and digest as the JAX package's
functions, so WAL files of the two packages read back through either.

The plane follows the faults/obs singleton pattern of the port: the CLI
installs it (``LLMC_INTEGRITY``, read by ``utils/knobs.py``) before any
provider exists, and consumers bind it at construction
(``self._integrity = integrity.plane()``), so a run without it pays one
``is not None`` check on the hot paths. The plane's sampling policy
(:meth:`IntegrityPlane.sample_hit`, ``LLMC_INTEGRITY_SAMPLE`` resolved by
the CLI) picks the KV pool's gathers to verify. The quarantine tracker and
the Prometheus families of the JAX plane belong to the serving tier, which
the port does not have.
"""

from __future__ import annotations

import json
import zlib
from typing import Optional

from llm_consensus_tpu_torch.analysis import sanitizer

# -- CRC32C (Castagnoli) ------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _crc32c_table() -> tuple:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, optionally continuing ``crc``."""
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# -- WAL record framing (recovery/journal.py) ---------------------------------

# Every framed WAL line is ``<crc32c-8-hex> <payload>``: the fixed-width
# checksum comes first, so the torn-tail scan decides whether a record
# survived without parsing its payload.
CHECKSUM_LEN = 8


def frame_wal_line(payload: str) -> str:
    """One WAL record framed for the disk mirror (no trailing newline)."""
    return f"{crc32c(payload.encode('utf-8')):0{CHECKSUM_LEN}x} {payload}"


def parse_wal_line(line: str) -> Optional[str]:
    """The payload of one framed WAL line, or None when the frame is torn
    or corrupt (short line, bad hex, checksum mismatch)."""
    if len(line) < CHECKSUM_LEN + 2 or line[CHECKSUM_LEN] != " ":
        return None
    try:
        want = int(line[:CHECKSUM_LEN], 16)
    except ValueError:
        return None
    payload = line[CHECKSUM_LEN + 1:]
    if crc32c(payload.encode("utf-8")) != want:
        return None
    return payload


# -- bulk content digests -----------------------------------------------------


def digest_bytes(data, seed: int = 0) -> str:
    """C-speed rolling digest of ``data`` (bytes or any C-contiguous
    buffer) as 8 hex chars."""
    return f"{zlib.crc32(data, seed) & 0xFFFFFFFF:08x}"


def crc32_str(s: str, crc: int = 0) -> int:
    """Roll ``s`` into a running ``zlib.crc32``: per-leaf digests combine
    into one digest without concatenating buffers."""
    return zlib.crc32(s.encode("utf-8"), crc) & 0xFFFFFFFF


def _host_array(arr):
    """``(dtype label, shape, C-contiguous host numpy array)`` of a torch
    tensor or a numpy array. The label is numpy's ``dtype.str``; a torch
    dtype numpy lacks (bfloat16) is labelled as the JAX package's numpy
    sees it (``<V2``), so equal bytes digest equally in both packages."""
    import numpy as np
    import torch

    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        try:
            host = t.numpy()
            label = host.dtype.str
        except TypeError:  # no numpy dtype: the raw bytes
            host = t.reshape(-1).view(torch.uint8).numpy()
            label = f"<V{t.element_size()}"
        return label, tuple(t.shape), host
    a = np.ascontiguousarray(np.asarray(arr))
    return a.dtype.str, a.shape, a


def digest_array(arr) -> str:
    """Digest of one array's dtype, shape and content: a bit flip, a
    reshape and a dtype cast all change it. Torch tensors are digested
    over a host copy of their bytes."""
    label, shape, host = _host_array(arr)
    seed = zlib.crc32(f"{label}:{shape}".encode("utf-8"))
    return digest_bytes(host, seed)  # the host copy's buffer, not a second copy


def _flatten(tree, path: str = ""):
    """``(path, leaf)`` pairs of nested dicts, lists and tuples, dict keys in
    sorted order (deterministic, like a pytree flatten)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    else:
        yield path, tree


def digest_tree(tree) -> str:
    """Digest of a parameter tree: its structure (every leaf's path) plus
    every leaf's content, combined in deterministic leaf order. The leaves
    are digested on up to 8 threads (a device-to-host copy and ``zlib``
    both release the GIL), so at most 8 host copies exist at once."""
    from concurrent.futures import ThreadPoolExecutor

    leaves = list(_flatten(tree))
    acc = zlib.crc32(repr([p for p, _ in leaves]).encode("utf-8"))
    with ThreadPoolExecutor(max_workers=8) as pool:
        for digest in pool.map(digest_array, [leaf for _, leaf in leaves]):
            acc = zlib.crc32(digest.encode("utf-8"), acc)
    return f"{acc & 0xFFFFFFFF:08x}"


def canonical_digest(doc: dict) -> str:
    """Digest of a JSON document under canonical encoding (sorted keys, no
    whitespace): stable across hosts and dict orderings."""
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return digest_bytes(blob.encode("utf-8"))


# -- the typed failure --------------------------------------------------------


class IntegrityError(RuntimeError):
    """A corruption was detected and contained. ``surface`` names the seam
    (``wal``, ``logits``, ...); a consumer sees the classified failure,
    never the corrupt bytes."""

    def __init__(self, surface: str, detail: str):
        super().__init__(f"integrity failure at {surface}: {detail}")
        self.surface = surface
        self.detail = detail


# -- counters -----------------------------------------------------------------


class IntegrityCounters:
    """Per-surface check/failure counters, mirrored into the obs recorder
    (``integrity.*`` counters of ``metrics.json``)."""

    def __init__(self):
        from llm_consensus_tpu_torch import obs

        self._lock = sanitizer.make_lock("integrity.counters")
        self._checks: dict = {}    # guarded by: _lock
        self._failures: dict = {}  # guarded by: _lock
        self._obs = obs.recorder()

    def check(self, surface: str, n: int = 1) -> None:
        with self._lock:
            self._checks[surface] = self._checks.get(surface, 0) + n
        if self._obs is not None:
            self._obs.count(f"integrity.checks.{surface}", n)

    def failure(self, surface: str, detail: str = "") -> None:
        with self._lock:
            self._failures[surface] = self._failures.get(surface, 0) + 1
        if self._obs is not None:
            self._obs.count(f"integrity.failures.{surface}")
            self._obs.instant("integrity_failure", tid="integrity", surface=surface,
                              detail=detail)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "checks": dict(self._checks),
                "failures": dict(self._failures),
                "checks_total": sum(self._checks.values()),
                "failures_total": sum(self._failures.values()),
            }

    def prom_families(self) -> dict:
        """The ``llmc_integrity_checks_total`` / ``_failures_total``
        families of ``/metricsz``, labeled by surface."""
        with self._lock:
            checks = dict(self._checks)
            failures = dict(self._failures)
        return {
            "integrity_checks_total": {
                "type": "counter",
                "samples": [({"surface": s}, n) for s, n in sorted(checks.items())],
            },
            "integrity_failures_total": {
                "type": "counter",
                "samples": [({"surface": s}, n) for s, n in sorted(failures.items())],
            },
        }


# -- quarantine hysteresis ----------------------------------------------------


class QuarantineTracker:
    """The enter/probe/exit hysteresis of one replica: :meth:`strike`
    returns True when the integrity failures cross ``threshold`` (once per
    crossing); while quarantined, :meth:`clean_probe` returns True after
    ``probe_n`` consecutive clean probe windows (a strike resets the run).
    The gateway reads ``LLMC_INTEGRITY_QUARANTINE_AFTER`` and
    ``LLMC_INTEGRITY_PROBE_N`` for these through ``utils/knobs.py``."""

    def __init__(self, threshold: int, probe_n: int):
        self._lock = sanitizer.make_lock("integrity.quarantine")
        self.threshold = max(1, threshold)
        self.probe_n = max(1, probe_n)
        self._strikes = 0        # guarded by: _lock
        self._clean_probes = 0   # guarded by: _lock
        self._quarantines = 0    # guarded by: _lock

    def strike(self) -> bool:
        """Record one integrity failure; True when quarantine should engage
        (exactly once per crossing of the threshold)."""
        with self._lock:
            self._strikes += 1
            self._clean_probes = 0
            if self._strikes == self.threshold:
                self._quarantines += 1
                return True
            return False

    def clean_probe(self) -> bool:
        """Record one clean probe window; True when the replica has earned
        its way back (``probe_n`` consecutive clean windows)."""
        with self._lock:
            self._clean_probes += 1
            if self._clean_probes >= self.probe_n:
                self._strikes = 0
                self._clean_probes = 0
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "strikes": self._strikes,
                "clean_probes": self._clean_probes,
                "quarantines": self._quarantines,
                "threshold": self.threshold,
                "probe_n": self.probe_n,
            }


def pair_digest(doc: dict) -> str:
    """Canonical content digest over the fields a distillation pair reads
    (prompt, consensus, the panel's response texts): what the serve
    scheduler stamps into ``result.json`` as ``integrity_digest`` with the
    plane on (the JAX ``flywheel/corpus.py`` ``pair_digest``)."""
    return canonical_digest({
        "prompt": doc.get("prompt"),
        "consensus": doc.get("consensus"),
        "responses": [
            r.get("content") if isinstance(r, dict) else None
            for r in (doc.get("responses") or [])
        ],
    })


# -- the plane ----------------------------------------------------------------


class IntegrityPlane:
    """Process-wide integrity plane: its counters and the sampling policy.

    Sampling (the KV pool's gather verification) is deterministic: every
    Nth call of :meth:`sample_hit` is a hit, ``N = round(1 / sample)``
    (``sample`` 0: never), so two identical runs verify the same gathers.
    ``sample`` defaults to the JAX ``LLMC_INTEGRITY_SAMPLE`` default."""

    def __init__(self, sample: float = 0.05):
        self.sample = max(0.0, min(1.0, float(sample)))
        self._sample_every = round(1.0 / self.sample) if self.sample else 0
        self._lock = sanitizer.make_lock("integrity.plane")
        self._sample_clock = 0  # guarded by: _lock
        self.counters = IntegrityCounters()

    def sample_hit(self) -> bool:
        """True when this sampled-verification site should verify now."""
        if not self._sample_every:
            return False
        with self._lock:
            self._sample_clock += 1
            if self._sample_clock >= self._sample_every:
                self._sample_clock = 0
                return True
            return False

    def check(self, surface: str, n: int = 1) -> None:
        self.counters.check(surface, n)

    def failure(self, surface: str, detail: str = "") -> None:
        self.counters.failure(surface, detail)

    def stats(self) -> dict:
        return self.counters.snapshot()


_lock = sanitizer.make_lock("integrity.registry")
_plane: Optional[IntegrityPlane] = None


def plane() -> Optional[IntegrityPlane]:
    """The installed integrity plane, or None when it is off."""
    return _plane


def counters() -> Optional[IntegrityCounters]:
    """The plane's counters, or None when the plane is off."""
    p = plane()
    return p.counters if p is not None else None


def install(p: Optional[IntegrityPlane]) -> None:
    """Install ``p`` as the process plane."""
    global _plane
    with _lock:
        _plane = p


def reset() -> None:
    """Forget the installed plane."""
    install(None)
