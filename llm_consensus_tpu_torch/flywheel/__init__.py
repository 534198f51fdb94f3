"""Data flywheel of the port (``llm_consensus_tpu/flywheel/``): served
corpus → judge distillation → live hot-swap.

  * :mod:`.corpus` — scan the run directories (``run.json`` manifests are
    the sole authority), extract (panel answers → judge verdict) pairs
    into a deduplicated, versioned training set with a deterministic
    train/holdout split;
  * :mod:`.distill` — distillation of the journaled judge onto a student
    model, on one device or over a mesh (soft-target KL from the teacher's logits plus
    hard-label CE on the verdict tokens), versioned HF safetensors
    checkpoints tagged with the corpus hash;
  * :mod:`.canary` — the rollout half: version-labeled latencies compared
    between baseline and canary, automatic rollback on a regression.

The hot-swap half lives with the weights: ``Engine.swap_weights`` and the
batcher's pins, ``GPUProvider.swap_weights`` and the gateway's
``POST /v1/swap``.
"""

from llm_consensus_tpu_torch.flywheel.canary import CanaryWatcher  # noqa: F401
from llm_consensus_tpu_torch.flywheel.corpus import (  # noqa: F401
    Corpus, Example, build_corpus, scan_run_dirs)

__all__ = ["CanaryWatcher", "Corpus", "Example", "build_corpus", "scan_run_dirs"]
