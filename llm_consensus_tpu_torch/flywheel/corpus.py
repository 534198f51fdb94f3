"""Flywheel corpus: (panel-answers → judge-verdict) pairs from data/ (a
copy of ``llm_consensus_tpu/flywheel/corpus.py``; the data directory and
the holdout share are arguments here, which the ``distill`` subcommand
resolves from ``LLMC_DATA_DIR`` and ``LLMC_DISTILL_HOLDOUT``).

``data/`` holds one dir per run — but not ONLY runs: the observability
stack parks auxiliary artifacts beside them (``blackbox/`` flight-
recorder dumps, ``roofline-*/`` profiles, ``elastic-r*/`` replica state;
new writers use ``data/_artifacts/``). The scanner therefore trusts
exactly one signal: a ``run.json`` manifest (written by both the CLI and
the serve scheduler before execution). No manifest → not a run → skipped,
whatever the dir looks like.

Each valid run contributes one training example: the rendered judge
prompt (the SAME template serving uses — consensus/judge.py
``render_judge_prompt``, so the student learns the distribution it will
be queried on) paired with the journaled verdict text. Examples dedup by
content hash (re-served prompts, cache-miss retries), split
deterministically into train/holdout by hash — stable across rescans, so
holdout examples never leak into train as the corpus grows — and the
whole set is identified by a corpus hash that checkpoint metadata carries
(flywheel/distill.py): a weight version names exactly the data it saw.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

# Reserved namespace for non-run artifacts under data/ (profiles, dumps,
# replica state). The manifest rule already skips them; the constant
# exists so writers and scanner agree on one name.
ARTIFACTS_DIRNAME = "_artifacts"


@dataclass
class Example:
    """One distillation pair: judge prompt in, judge verdict out."""

    run_id: str
    prompt: str  # rendered judge prompt (teacher/student input)
    verdict: str  # journaled consensus text (hard-label target)
    key: str = ""  # content hash — dedup + split identity

    def __post_init__(self) -> None:
        if not self.key:
            h = hashlib.sha256()
            h.update(self.prompt.encode("utf-8"))
            h.update(b"\x00")
            h.update(self.verdict.encode("utf-8"))
            self.key = h.hexdigest()


@dataclass
class Corpus:
    """A versioned, deduplicated training set extracted from data/."""

    corpus_hash: str
    train: list = field(default_factory=list)
    holdout: list = field(default_factory=list)
    runs_scanned: int = 0  # dirs with a run.json manifest
    runs_skipped: int = 0  # dirs without one (artifacts, foreign)
    runs_corrupt: int = 0  # manifested runs whose payload didn't parse
    deduped: int = 0  # duplicate pairs dropped
    # Booked exclusions (integrity plane): the run ids whose pairs were
    # refused — torn JSON, digest mismatches, injected corruption — so
    # an operator can audit exactly which data the student never saw.
    corrupt_ids: list = field(default_factory=list)

    @property
    def version(self) -> str:
        """Short corpus identity for checkpoint tags and logs."""
        return self.corpus_hash[:12]

    def summary(self) -> dict:
        return {
            "corpus_hash": self.corpus_hash,
            "version": self.version,
            "train": len(self.train),
            "holdout": len(self.holdout),
            "runs_scanned": self.runs_scanned,
            "runs_skipped": self.runs_skipped,
            "runs_corrupt": self.runs_corrupt,
            "corrupt_ids": list(self.corrupt_ids),
            "deduped": self.deduped,
        }


def scan_run_dirs(data_dir: str) -> "tuple[list, int]":
    """``([(run_id, run_dir)], skipped)`` — manifest-validated run dirs.

    ``run.json`` is the sole authority: a dir without one (or with one
    that isn't a JSON object) is skipped and counted, never guessed at
    by name shape. Sorted by run id so the corpus is order-stable.
    """
    runs: list = []
    skipped = 0
    try:
        entries = sorted(os.listdir(data_dir))
    except OSError:
        return [], 0
    for name in entries:
        run_dir = os.path.join(data_dir, name)
        if not os.path.isdir(run_dir):
            continue
        manifest_path = os.path.join(run_dir, "run.json")
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            skipped += 1
            continue
        if not isinstance(manifest, dict):
            skipped += 1
            continue
        runs.append((name, run_dir))
    return runs, skipped


def pair_digest(doc: dict) -> str:
    """Canonical content digest over the fields a distillation pair
    consumes (prompt, consensus verdict, panel response texts) — what
    the serve scheduler stamps into ``result.json`` as
    ``integrity_digest`` and :func:`_extract` re-derives before a pair
    may enter the corpus."""
    from llm_consensus_tpu_torch import integrity

    return integrity.pair_digest(doc)


def _extract(run_id: str, run_dir: str) -> Optional[Example]:
    """One run's distillation pair, or None when the payload is unusable
    (no result.json yet — crashed/in-flight run — empty verdict, or a
    single-response run the judge never actually synthesized)."""
    path = os.path.join(run_dir, "result.json")
    if not os.path.exists(path):
        return None  # in-flight or crashed run: manifest only, no result
    try:
        with open(path, "r", encoding="utf-8") as f:
            result = json.load(f)
    except (OSError, ValueError):
        raise CorruptRun(run_id)
    if not isinstance(result, dict):
        raise CorruptRun(run_id)
    from llm_consensus_tpu_torch import integrity

    plane = integrity.plane()
    want = result.get("integrity_digest")
    if plane is not None and isinstance(want, str):
        # A stamped pair must reproduce its digest: a run dir whose
        # bytes rotted after the stamp (or were tampered with) is a
        # poisoned training example — book it, never distill it.
        plane.check("corpus")
        if pair_digest(result) != want:
            plane.failure(
                "corpus", f"pair digest mismatch in run {run_id}"
            )
            raise CorruptRun(run_id)
    verdict = result.get("consensus")
    responses = result.get("responses")
    if not verdict or not isinstance(responses, list) or len(responses) < 2:
        # One response is returned verbatim (judge.go:74-79 parity) —
        # there is no judge behavior to distill from it.
        return None
    from llm_consensus_tpu_torch.consensus.judge import render_judge_prompt
    from llm_consensus_tpu_torch.providers.base import Response

    panel = []
    for r in responses:
        if not isinstance(r, dict) or not r.get("content"):
            return None
        panel.append(Response(
            model=str(r.get("model", "")),
            content=str(r["content"]),
            provider=str(r.get("provider", "")),
        ))
    prompt = render_judge_prompt(str(result.get("prompt", "")), panel)
    return Example(run_id=run_id, prompt=prompt, verdict=str(verdict))


class CorruptRun(ValueError):
    """A manifested run whose result.json does not parse."""


def build_corpus(data_dir: str = "data", holdout: float = 0.2) -> Corpus:
    """Scan ``data_dir``, extract, dedup, and split the corpus.

    Deterministic end to end: dirs scan sorted, dedup keeps the first
    occurrence, and the split hashes each example's content key — an
    example lands on the same side of the split however many runs
    surround it. Corrupt runs (torn result.json, injected
    ``corpus_corrupt``) are counted and skipped, never fatal: a corpus
    build must survive the journal of a crashed serving process.
    """
    holdout = min(max(float(holdout), 0.0), 1.0)
    from llm_consensus_tpu_torch import faults

    plan = faults.plan()
    runs, skipped = scan_run_dirs(data_dir)
    corpus = Corpus(corpus_hash="", runs_skipped=skipped)
    seen: set = set()
    examples: list = []
    for run_id, run_dir in runs:
        corpus.runs_scanned += 1
        if plan is not None:
            hit = plan.fire("swap", phase="corpus", run=run_id)
            if hit is not None and hit.kind == "corpus_corrupt":
                corpus.runs_corrupt += 1
                corpus.corrupt_ids.append(run_id)
                continue
        try:
            ex = _extract(run_id, run_dir)
        except CorruptRun:
            corpus.runs_corrupt += 1
            corpus.corrupt_ids.append(run_id)
            continue
        if ex is None:
            continue
        if ex.key in seen:
            corpus.deduped += 1
            continue
        seen.add(ex.key)
        examples.append(ex)
    h = hashlib.sha256()
    for ex in examples:
        h.update(ex.key.encode("ascii"))
    corpus.corpus_hash = h.hexdigest()
    for ex in examples:
        # Split on a DIFFERENT hash than the dedup key's raw prefix so
        # the fraction is uniform even if key prefixes ever correlate
        # with content shape.
        frac = int(hashlib.sha256(
            ex.key.encode("ascii") + b"/split"
        ).hexdigest()[:8], 16) / float(16 ** 8)
        (corpus.holdout if frac < holdout else corpus.train).append(ex)
    return corpus


def encode_examples(tokenizer, examples: list, seq: int) -> dict:
    """Token batch for the distill step: ``{tokens, targets, mask}``.

    Per example: ``BOS + prompt_ids + verdict_ids``, next-token shifted,
    truncated/padded to ``seq``. The loss mask covers ONLY positions
    whose *target* is a verdict token — the student is graded on judging,
    not on parroting the panel prompt — and padding is dead. Long prompts
    truncate from the LEFT (keep the verdict and the panel tail nearest
    it); examples whose verdict is entirely cut are dropped by mask.

    Returns plain nested lists (callers make tensors of them), so
    corpus-only tooling needs no torch.
    """
    tokens, targets, mask = [], [], []
    for ex in examples:
        prompt_ids = tokenizer.encode(ex.prompt, add_bos=True)
        verdict_ids = tokenizer.encode(ex.verdict, add_bos=False)
        ids = prompt_ids + verdict_ids
        is_verdict = [0] * len(prompt_ids) + [1] * len(verdict_ids)
        if len(ids) > seq + 1:
            ids = ids[-(seq + 1):]
            is_verdict = is_verdict[-(seq + 1):]
        row_t = ids[:-1]
        row_y = ids[1:]
        row_m = is_verdict[1:]
        pad = seq - len(row_t)
        if pad > 0:
            row_t = row_t + [0] * pad
            row_y = row_y + [0] * pad
            row_m = row_m + [0] * pad
        tokens.append(row_t)
        targets.append(row_y)
        mask.append([float(m) for m in row_m])
    return {"tokens": tokens, "targets": targets, "mask": mask}


__all__ = [
    "ARTIFACTS_DIRNAME", "Corpus", "CorruptRun", "Example",
    "build_corpus", "encode_examples", "pair_digest", "scan_run_dirs",
]
