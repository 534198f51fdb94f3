"""Crash recovery: stream journaling + engine supervision (port of
``llm_consensus_tpu/recovery/``).

A batched pool is the failure unit: one engine fault kills every in-flight
stream of the shared ``ContinuousBatcher``. This package makes requests
survive engine death:

  * :mod:`~llm_consensus_tpu_torch.recovery.journal`: a write-ahead journal
    of every active stream (prompt ids, sampling params, tokens emitted so
    far), kept by the batcher's submit and emit paths, optionally mirrored
    to CRC32C-framed ``.wal`` files.
  * :mod:`~llm_consensus_tpu_torch.recovery.supervisor`: the watchdog that
    detects a crashed or wedged pool, has the provider rebuild it, and
    **replays** the journaled streams: re-prefill prompt + emitted prefix
    into the fresh pool and continue decoding from the recorded frontier.

The JAX package resolves a process journal from ``LLMC_JOURNAL``; the port
passes the journal to its consumers (``GPUProvider(journal=)``,
``ContinuousBatcher(journal=)``), and the CLI builds it from the knob
(``utils/knobs.py``).
"""

from __future__ import annotations

from llm_consensus_tpu_torch.recovery.journal import (  # noqa: F401 — public API
    JournalEntry, StreamJournal, read_wal)
from llm_consensus_tpu_torch.recovery.supervisor import (  # noqa: F401
    DEFAULT_HEARTBEAT_S, DEFAULT_MAX_RESTARTS, EngineSupervisor, EngineWedged, device_error)

__all__ = [
    "DEFAULT_HEARTBEAT_S", "DEFAULT_MAX_RESTARTS", "EngineSupervisor", "EngineWedged",
    "JournalEntry", "StreamJournal", "device_error", "read_wal",
]
