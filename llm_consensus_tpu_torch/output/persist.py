"""Run persistence: every run auto-saved to data/<run-id>/ (a copy of
``llm_consensus_tpu/output/persist.py``).

Layout: ``run.json`` (the manifest, written before the panel fan-out),
``panel/NNN-<slug>.json`` (each answer as it lands), ``result.json``,
``prompt.txt``, ``consensus.md``. Run ids are a timestamp plus 3 random
bytes in hex, e.g. ``20260112-143052-a1b2c3``.
"""

from __future__ import annotations

import os
import secrets
import tempfile
import threading
import time
from typing import Callable, Optional

# In-process collision guard for generate_run_id: the id format is
# wall-clock-derived down to the second, so a burst of concurrent server
# runs can draw the same timestamp — and 3 random bytes alone leave a
# birthday collision on the table. Remembering the ids issued within the
# CURRENT second (the set resets when the second rolls over, so memory
# stays bounded on a long-lived server) makes two calls from one process
# provably never collide, while keeping the id format intact.
_id_lock = threading.Lock()
_id_second = ""
_id_issued: set = set()


def generate_run_id(now: float | None = None) -> str:
    global _id_second
    ts = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    with _id_lock:
        if ts != _id_second:
            _id_second = ts
            _id_issued.clear()
        while True:
            run_id = f"{ts}-{secrets.token_hex(3)}"
            if run_id not in _id_issued:
                _id_issued.add(run_id)
                return run_id


def reserve_run_dir(
    data_dir: str, now: float | None = None, attempts: int = 64
) -> tuple[str, str]:
    """Atomically claim a fresh ``data/<run-id>/``; returns (run_id, path).

    The authoritative cross-process guard: the exclusive ``mkdir`` is the
    reservation, and an id another process (or an earlier crash) already
    claimed is simply redrawn — retry-on-exists, as many times as it
    takes (bounded only to turn a pathological filesystem into an error
    instead of a spin).
    """
    last_err: Optional[OSError] = None
    for _ in range(attempts):
        run_id = generate_run_id(now)
        path = os.path.join(data_dir, run_id)
        try:
            os.makedirs(path, exist_ok=False)
        except FileExistsError as err:
            last_err = err
            continue
        return run_id, path
    raise OSError(
        f"could not reserve a unique run dir under {data_dir!r} "
        f"after {attempts} attempts"
    ) from last_err


def save_file(
    run_dir: str,
    name: str,
    content: "str | bytes",
    warn: Optional[Callable[[str], None]] = None,
) -> Optional[str]:
    """Crash-safely write one aux file into ``run_dir`` (created if
    needed): write to a temp file in the SAME directory, fsync, then
    ``os.replace`` into place, then fsync the DIRECTORY — the rename
    alone is atomic but not durable, and a power cut after return must
    not roll the directory entry back to nothing. A crash mid-write
    leaves either the old file or the new one, never a torn
    ``trace.json``/``metrics.json`` (the resume path reads these dirs
    back, so torn JSON is not merely cosmetic).

    Non-fatal like every aux write of a run: a failure
    is reported via ``warn`` and returns None — telemetry and fault traces
    must never fail a run that already produced its answer. Returns the
    written path on success.
    """
    path = os.path.join(run_dir, name)
    tmp = None
    try:
        os.makedirs(run_dir, exist_ok=True)
        data = content if isinstance(content, bytes) else content.encode("utf-8")
        fd, tmp = tempfile.mkstemp(
            dir=run_dir, prefix=f".{os.path.basename(name)}.", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            tmp = None
            _fsync_dir(run_dir)
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
    except OSError as err:
        if warn is not None:
            warn(f"Failed to save {name.split('.')[0]}: {err}")
        return None
    return path


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync: makes a just-renamed entry durable
    (the file fsync above only hardened its bytes, not the name)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory-open semantics
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_aux_files(
    run_dir: str,
    prompt: str,
    consensus: str,
    warn: Optional[Callable[[str], None]] = None,
) -> str:
    """Create ``run_dir`` and write prompt.txt / consensus.md into it.

    Write failures of the aux files are non-fatal, reported via ``warn``.
    result.json is written by the caller through the common output-path
    branch. Returns the result.json path for that branch.
    """
    os.makedirs(run_dir, exist_ok=True)
    for name, content in (("prompt.txt", prompt), ("consensus.md", consensus)):
        save_file(run_dir, name, content, warn=warn)
    return os.path.join(run_dir, "result.json")
