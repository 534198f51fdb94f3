"""``distill`` — the offline half of the data flywheel (port of
``llm_consensus_tpu/cli/distill.py``).

One shot: scan the serving journal (``data/<run-id>/`` manifests), build
the deduplicated (panel answers → judge verdict) corpus, distill the
journaled judge onto a student model (flywheel/distill.py), and save a
versioned HF safetensors checkpoint ready for the gateway's
``POST /v1/swap``. Prints one JSON summary (corpus counts, holdout loss
before and after, the checkpoint's version and path); an empty corpus
prints the summary with an error and exits 2.

Unset flags take the ``LLMC_DATA_DIR`` and ``LLMC_DISTILL_*`` knobs
(``utils/knobs.py``), passed on as arguments. ``distill_main(device=None)``
trains on the current CUDA card and raises without one; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, TextIO

from llm_consensus_tpu_torch.utils import knobs
from llm_consensus_tpu_torch.utils.device import DeviceLike


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llm-consensus-torch distill",
        description="Distill the journaled judge onto a student model "
        "and emit a hot-swappable versioned checkpoint.",
    )
    p.add_argument("--data-dir", default=None,
                   help="serving journal root to scan (default LLMC_DATA_DIR)")
    p.add_argument("--student", default="tiny-llama",
                   help="student model preset (default tiny-llama)")
    p.add_argument("--teacher", default=None,
                   help="teacher preset (default: the student — self-distillation "
                   "from the journaled verdicts)")
    p.add_argument("--out", default=None,
                   help="checkpoint output root (default <data-dir>/_artifacts/"
                   "distill); versions land at <out>/vNNNN/")
    p.add_argument("--checkpoints", default=None,
                   help="serving checkpoint root to warm-start student/teacher "
                   "from (random-init when absent)")
    p.add_argument("--steps", type=int, default=None,
                   help="train steps (default LLMC_DISTILL_STEPS)")
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default LLMC_DISTILL_LR)")
    p.add_argument("--batch", type=int, default=None,
                   help="global batch size (default LLMC_DISTILL_BATCH)")
    p.add_argument("--seq", type=int, default=None,
                   help="sequence length (default LLMC_DISTILL_SEQ)")
    p.add_argument("--temperature", type=float, default=None,
                   help="soft-target temperature (default LLMC_DISTILL_TEMP)")
    p.add_argument("--alpha", type=float, default=None,
                   help="KL weight in the KL/CE mix (default LLMC_DISTILL_ALPHA)")
    p.add_argument("--holdout", type=float, default=None,
                   help="holdout fraction (default LLMC_DISTILL_HOLDOUT)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress progress lines (JSON summary only)")
    return p


def distill_main(argv: list, stdout: Optional[TextIO] = None, stderr: Optional[TextIO] = None,
                 install_signal_handlers: bool = True,  # noqa: ARG001 — CLI entry parity
                 device: DeviceLike = None) -> int:
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr
    args = build_parser().parse_args(argv)

    from llm_consensus_tpu_torch.flywheel.corpus import ARTIFACTS_DIRNAME, build_corpus

    settings = knobs.flywheel_settings()
    data_dir = args.data_dir or knobs.data_dir()
    log = (lambda _m: None) if args.quiet else (
        lambda m: (stderr.write(f"{m}\n"), stderr.flush()))
    log(f"scanning {data_dir} ...")
    holdout = args.holdout if args.holdout is not None else settings["holdout"]
    corpus = build_corpus(data_dir=data_dir, holdout=holdout)
    summary: dict = {"corpus": corpus.summary()}
    if not corpus.train:
        # An empty corpus is an operator signal (exit 2), not a crash.
        summary["error"] = "no training examples in corpus"
        stdout.write(json.dumps(summary, indent=2) + "\n")
        return 2
    out_dir = args.out or os.path.join(data_dir, ARTIFACTS_DIRNAME, "distill")
    summary.update(run_corpus_distill(corpus, args, settings, out_dir, log, device))
    stdout.write(json.dumps(summary, indent=2) + "\n")
    return 0


def run_corpus_distill(corpus, args, settings: dict, out_dir: str, log,
                       device: DeviceLike = None) -> dict:
    """The torch half, split out so a corpus-only failure (exit 2) never
    imports the engine."""
    from llm_consensus_tpu_torch.flywheel.distill import run_distill

    def pick(flag, key):
        return flag if flag is not None else settings[key]

    return run_distill(
        corpus, student=args.student, teacher=args.teacher, out_dir=out_dir,
        device=device, checkpoint_dir=args.checkpoints, steps=pick(args.steps, "steps"),
        lr=pick(args.lr, "lr"), batch=pick(args.batch, "batch"), seq=pick(args.seq, "seq"),
        temperature=pick(args.temperature, "temperature"), alpha=pick(args.alpha, "alpha"),
        ckpt_every=settings["ckpt_every"], log=log)
