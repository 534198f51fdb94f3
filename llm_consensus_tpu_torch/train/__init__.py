"""Training layer of the port (``llm_consensus_tpu/train/``): the loss and
the train step, on one device or over a mesh.

Modules:
  loss — next-token cross-entropy (fp32, masked) and the distillation
         KL/CE mix (flywheel/distill.py's objective)
  step — ``TrainState``, the optimizer (AdamW behind a global-norm clip),
         ``make_train_step`` (activation checkpointing per layer)

Over a mesh (``mesh=``, parallel/) the parameters are tensor- and
expert-sharded and the data-parallel rows' gradients all-reduce.
"""

from llm_consensus_tpu_torch.train.loss import cross_entropy_loss, distill_loss
from llm_consensus_tpu_torch.train.step import (
    OptimizerSpec, TrainState, default_optimizer, init_train_state, make_train_step)

__all__ = [
    "OptimizerSpec",
    "TrainState",
    "cross_entropy_loss",
    "default_optimizer",
    "distill_loss",
    "init_train_state",
    "make_train_step",
]
