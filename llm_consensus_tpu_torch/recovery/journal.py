"""Per-stream write-ahead journal: what recovery needs to replay a stream
(a copy of ``llm_consensus_tpu/recovery/journal.py``).

One :class:`JournalEntry` per submitted stream holds exactly the state a
restarted engine needs to resume it: the budgeted prompt ids, the
sampling params, and every token emitted so far (appended from the
batcher's emit path — one list append per token; the disabled path in the
batcher is a per-stream ``is not None`` check, so a run without a journal
pays nothing on the decode hot loop).

Entries are *sealed* before a replay snapshot is taken: a wedged engine's
fetch worker may wake later and try to append tokens the replacement pool
is already regenerating — sealed entries drop those appends, so the
snapshot the replay prefilled stays the entry's authoritative prefix.

With a journal directory configured (``StreamJournal(path=<dir>)``; the
CLI's ``LLMC_JOURNAL=<dir>``), each entry mirrors to an append-only
``<pid>-<sid>.wal`` file — a JSON header line (prompt
ids + sampling) followed by one token id per line, closed with a
``#finish=<reason>`` line. Every record is CRC32C-framed
(``<crc-8-hex> <payload>`` — integrity/core.py): a torn disk write or a
flipped bit is *detected* on read instead of parsing as a wrong token.
:func:`read_wal` is the torn-tail-tolerant reader — it verifies every
frame, truncates the file to the last good record (instead of
parse-or-die on a torn tail), and returns the surviving prefix in
exactly the shape the normal replay contract consumes (prompt ids +
sampling + emitted-token prefix; the replay regenerates the rest
deterministically). The in-process supervisor still replays from
memory; the file is for post-mortems, debugging, and cross-process
recovery.
"""

from __future__ import annotations

import json
import os

from typing import Optional

from llm_consensus_tpu_torch import integrity
from llm_consensus_tpu_torch.analysis import sanitizer


class JournalEntry:
    """Journal of one stream: prompt, sampling, emitted tokens."""

    __slots__ = (
        "_journal", "sid", "prompt_ids", "sampling", "_tokens", "_lock",
        "_sealed", "_file", "finish", "replay_of", "trace",
    )

    def __init__(self, journal: "StreamJournal", sid: int,
                 prompt_ids: list[int], sampling,
                 tokens: Optional[list[int]] = None,
                 replay_of: Optional[int] = None,
                 trace: Optional[str] = None):
        self._journal = journal
        self.sid = sid
        self.prompt_ids = list(prompt_ids)
        self.sampling = sampling
        self._tokens = list(tokens) if tokens else []
        self._lock = sanitizer.make_lock("recovery.journal.entry")
        self._sealed = False
        self._file = None
        self.finish: Optional[str] = None
        self.replay_of = replay_of  # sid of the incarnation this resumes
        # Cross-hop request trace id (obs/live): survives seal/reopen so
        # one id links every incarnation of a preempted/replayed stream.
        self.trace = trace

    # -- recording (batcher emit path) ---------------------------------------

    def append(self, tok: int) -> None:
        """Record one emitted token. Dropped once sealed — a stale
        incarnation's late emits must not race the replay snapshot."""
        with self._lock:
            if self._sealed:
                return
            self._tokens.append(tok)
            if self._file is not None:
                try:
                    self._file.write(integrity.frame_wal_line(str(tok)) + "\n")
                except OSError:
                    self._file = None  # disk mirror is best-effort

    def seal(self) -> list[int]:
        """Freeze the entry and return the authoritative token snapshot.
        Called by the supervisor before replay: every token in the
        snapshot is re-prefilled; anything a stale worker appends after
        is dropped here and regenerated by the replay."""
        with self._lock:
            self._sealed = True
            return list(self._tokens)

    def tokens(self) -> list[int]:
        with self._lock:
            return list(self._tokens)

    def close(self, finish: str) -> None:
        """The stream resolved (eos/length/deadline/cancelled): retire
        the entry from the journal's active set."""
        with self._lock:
            if self.finish is not None:
                return
            self.finish = finish
            self._sealed = True
            if self._file is not None:
                try:
                    line = integrity.frame_wal_line(f"#finish={finish}") + "\n"
                    from llm_consensus_tpu_torch import faults

                    plan = faults.plan()
                    if plan is not None:
                        fs = plan.fire("corrupt", surface="wal", sid=self.sid)
                        if fs is not None and fs.kind == "torn_wal_tail":
                            # Crash mid-append: an unterminated tail with
                            # no newline — read_wal must truncate back to
                            # the last good record.
                            line = line[: max(1, len(line) // 2)]
                            line = line.rstrip("\n")
                        elif fs is not None and fs.kind == "bit_flip":
                            # One flipped payload bit: the frame CRC no
                            # longer reproduces, so the record is refused
                            # on read instead of parsing wrong.
                            line = (
                                line[:9] + chr(ord(line[9]) ^ 1) + line[10:]
                            )
                    self._file.write(line)
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        self._journal._retire(self)

    @property
    def open(self) -> bool:
        with self._lock:
            return self.finish is None


class StreamJournal:
    """Thread-safe registry of the active streams' journal entries."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = sanitizer.make_lock("recovery.journal")
        self._next_sid = 0
        self._active: dict[int, JournalEntry] = {}
        # Lifetime counters (healthz/statsz read these).
        self.opened = 0
        self.closed = 0

    def record(self, prompt_ids: list[int], sampling,
               tokens: Optional[list[int]] = None,
               replay_of: Optional[JournalEntry] = None,
               trace: Optional[str] = None) -> JournalEntry:
        """Open one stream's entry. ``tokens`` seeds a replay entry with
        the prior incarnation's emitted prefix; ``replay_of`` links it;
        ``trace`` carries the request trace id across incarnations."""
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            entry = JournalEntry(
                self, sid, prompt_ids, sampling, tokens=tokens,
                replay_of=replay_of.sid if replay_of is not None else None,
                trace=trace,
            )
            self._active[sid] = entry
            self.opened += 1
        if self._path is not None:
            try:
                os.makedirs(self._path, exist_ok=True)
                # pid-qualified name: sids restart at 0 per process, and
                # a restarted service must never truncate the crashed
                # run's WAL files — the post-mortem they exist for.
                f = open(  # noqa: SIM115 — held open for appends
                    os.path.join(self._path, f"{os.getpid()}-{sid}.wal"),
                    "w", encoding="utf-8",
                )
                header = {
                    "sid": sid,
                    "prompt_ids": entry.prompt_ids,
                    "sampling": _sampling_dict(sampling),
                    "replay_of": entry.replay_of,
                    "trace": entry.trace,
                }
                f.write(integrity.frame_wal_line(json.dumps(header)) + "\n")
                for t in entry._tokens:
                    f.write(integrity.frame_wal_line(str(t)) + "\n")
                entry._file = f
            except OSError:
                entry._file = None  # best-effort mirror
        return entry

    def _retire(self, entry: JournalEntry) -> None:
        with self._lock:
            if self._active.pop(entry.sid, None) is not None:
                self.closed += 1

    def depth(self) -> int:
        """Streams journaled and not yet resolved."""
        with self._lock:
            return len(self._active)

    def active(self) -> list[JournalEntry]:
        with self._lock:
            return list(self._active.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._active),
                "opened": self.opened,
                "closed": self.closed,
            }


def _sampling_dict(sampling) -> dict:
    try:
        from dataclasses import asdict

        return asdict(sampling)
    except TypeError:
        return {"repr": repr(sampling)}


def read_wal(path: str, repair: bool = True) -> Optional[dict]:
    """Torn-tail-tolerant WAL reader: CRC-verify every framed record,
    keep the longest good prefix, and (with ``repair``) physically
    truncate the file to it — truncate-to-last-good instead of
    parse-or-die, so a crash mid-append or a flipped bit costs at most
    the torn tail, never the stream.

    Returns ``{"header", "tokens", "finish", "records", "truncated"}``
    — exactly the replay contract's inputs (prompt ids + sampling in the
    header, the emitted-token prefix in ``tokens``; a replay re-prefills
    the prefix and regenerates the rest deterministically) — or ``None``
    when not even the header record survived. Only records terminated by
    a newline count: an unterminated tail is by definition torn."""
    plane = integrity.plane()
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    good_end = 0  # byte offset one past the last good record's newline
    header: Optional[dict] = None
    tokens: list[int] = []
    finish: Optional[str] = None
    records = 0
    offset = 0
    torn = False
    while offset < len(blob):
        nl = blob.find(b"\n", offset)
        if nl < 0:
            torn = True  # unterminated tail: the write never completed
            break
        try:
            line = blob[offset:nl].decode("utf-8")
        except UnicodeDecodeError:
            line = None
        payload = integrity.parse_wal_line(line) if line is not None else None
        if plane is not None:
            plane.check("wal")
        if payload is None:
            torn = True
            break
        if header is None:
            try:
                doc = json.loads(payload)
                if not isinstance(doc, dict):
                    raise ValueError("WAL header must be an object")
            except ValueError:
                torn = True
                break
            header = doc
        elif payload.startswith("#finish="):
            finish = payload[len("#finish="):]
        else:
            try:
                tokens.append(int(payload))
            except ValueError:
                torn = True
                break
        records += 1
        offset = nl + 1
        good_end = offset
    truncated = good_end < len(blob)
    if torn and plane is not None:
        plane.failure("wal", f"torn/corrupt record after {records} good")
    if truncated and repair:
        try:
            with open(path, "r+b") as f:
                f.truncate(good_end)
        except OSError:
            pass  # read-only mirror: the parsed prefix is still good
    if header is None:
        return None
    return {
        "header": header,
        "tokens": tokens,
        "finish": finish,
        "records": records,
        "truncated": truncated,
    }
