"""The integrity plane of the port (a copy of
``llm_consensus_tpu/integrity/``, cut to the surfaces the port has).

  * **Detect**: CRC32C framing on every ``StreamJournal`` WAL record
    (recovery/journal.py), parameter-tree digests (:func:`digest_tree`),
    and the finite-logit sentinel of the batched decode
    (``Engine._decode_chunk(sentinel=True)``: ``isfinite`` over each
    step's logits, AND-folded into a per-row verdict that rides the
    chunk's token fetch).
  * **Contain**: a poisoned row fails only its own stream with a typed
    :class:`IntegrityError`; its neighbours emit unchanged.
  * **Repair**: a WAL torn tail truncates to the last good record and
    feeds the normal replay contract (``recovery.read_wal``).

The plane is opt-in (``LLMC_INTEGRITY=1``, installed by the CLI): consumers
bind it once at construction, so a run without it pays one ``is not None``
check, and a clean run with it gives the same tokens as one without.
"""

from __future__ import annotations

from llm_consensus_tpu_torch.integrity.core import (  # noqa: F401 — public API
    CHECKSUM_LEN,
    IntegrityCounters,
    IntegrityError,
    IntegrityPlane,
    QuarantineTracker,
    canonical_digest,
    counters,
    crc32_str,
    crc32c,
    digest_array,
    digest_bytes,
    digest_tree,
    frame_wal_line,
    install,
    pair_digest,
    parse_wal_line,
    plane,
    reset,
)

__all__ = [
    "CHECKSUM_LEN", "IntegrityCounters", "IntegrityError", "IntegrityPlane",
    "QuarantineTracker", "canonical_digest", "counters", "crc32c", "crc32_str", "digest_array",
    "digest_bytes", "digest_tree", "frame_wal_line", "install", "pair_digest", "parse_wal_line",
    "plane", "reset",
]
