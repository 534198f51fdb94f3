"""The train step on one device (port of ``llm_consensus_tpu/train/step.py``
without its mesh arguments, which wait for ``parallel/``).

  * The optimizer is the JAX default: a global-norm clip at 1.0 chained
    with AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1), here
    ``torch.nn.utils.clip_grad_norm_`` and ``torch.optim.AdamW``. Two
    differences, both stated: the clip scales by ``max_norm / (norm +
    1e-6)`` where optax scales by ``max_norm / norm`` (a relative change of
    1e-6 / norm, only when the clip is active), and weight decay reaches
    every parameter in both (optax's ``adamw`` without a mask decays every
    leaf, norms and embeddings included; the port builds one parameter
    group). AdamW's update is optax's: ``p - lr * (m_hat / (sqrt(v_hat) +
    eps) + wd * p)``.
  * ``remat`` runs each layer of the cache-less forward under
    ``torch.utils.checkpoint`` (the JAX per-layer ``jax.checkpoint``).
  * Parameters are the model's tree (``init_params`` layout) with every
    leaf requiring grad; the optimizer updates them in place (the JAX
    step donates the previous state for the same reason).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.models.transformer import forward, init_params, param_leaves
from llm_consensus_tpu_torch.train.loss import cross_entropy_loss
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class OptimizerSpec:
    """The optimizer a train state builds over its parameters: ``adamw``
    (the JAX ``optax.adamw``) or ``sgd`` (``optax.sgd``, no moments), with
    an optional global-norm clip before it (``optax.clip_by_global_norm``)."""

    kind: str = "adamw"
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def build(self, leaves: list) -> torch.optim.Optimizer:
        if self.kind == "sgd":
            return torch.optim.SGD(leaves, lr=self.lr)
        if self.kind != "adamw":
            raise ValueError(f"unknown optimizer {self.kind!r}")
        return torch.optim.AdamW(leaves, lr=self.lr, betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      clip_norm: float = 1.0) -> OptimizerSpec:
    """AdamW behind a global-norm clip: the boring, correct default."""
    return OptimizerSpec("adamw", lr=lr, weight_decay=weight_decay, clip_norm=clip_norm)


def sgd(lr: float) -> OptimizerSpec:
    """Plain SGD, no clip (``optax.sgd``)."""
    return OptimizerSpec("sgd", lr=lr, weight_decay=0.0, clip_norm=None)


@dataclass
class TrainState:
    step: int
    params: dict
    optimizer: OptimizerSpec
    opt_state: torch.optim.Optimizer = field(repr=False)

    def leaves(self) -> list:
        return [w for _name, w in param_leaves(self.params)]


def _trainable(params: dict, copy: bool) -> dict:
    """The tree with every leaf a grad-requiring leaf tensor: copies when
    ``copy`` (an adopted tree must not be updated in place under its
    owner), else the tensors themselves detached from any graph."""
    def leaf(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone() if copy or t.is_inference() else t.detach()
        return t.requires_grad_(True)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

    return walk(params)


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     optimizer: Optional[OptimizerSpec] = None, *,
                     device: DeviceLike = None, dtype: torch.dtype = torch.bfloat16,
                     params: Optional[dict] = None) -> TrainState:
    """Parameters (random from ``seed`` on the device, or a copy of
    ``params``) and the optimizer's state over them. ``device=None`` is the
    current CUDA card (raises without one)."""
    optimizer = optimizer or default_optimizer()
    if params is None:
        params = _trainable(init_params(cfg, seed, device=resolve_device(device), dtype=dtype),
                            copy=False)
    else:
        params = _trainable(params, copy=True)
    leaves = [w for _name, w in param_leaves(params)]
    return TrainState(step=0, params=params, optimizer=optimizer,
                      opt_state=optimizer.build(leaves))


def global_norm(tensors: list) -> torch.Tensor:
    """The l2 norm over every tensor (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip (when the optimizer clips) and step; returns the unclipped
    global gradient norm."""
    leaves = state.leaves()
    if state.optimizer.clip_norm is not None:
        norm = torch.nn.utils.clip_grad_norm_(leaves, state.optimizer.clip_norm)
    else:
        norm = global_norm([w.grad if w.grad is not None else torch.zeros_like(w)
                            for w in leaves])
    state.opt_state.step()
    state.step += 1
    return norm


def make_train_step(cfg: ModelConfig, remat: bool = True):
    """``step_fn(state, batch) -> (state, metrics)``: ``batch`` is
    ``{"tokens", "targets", "mask"}`` each [B, T] (tensors on the state's
    device); metrics carry ``loss`` and ``grad_norm`` as floats. The state
    is updated in place, with the optimizer it was built with, and
    returned (the JAX step takes the optimizer as an argument)."""

    def step_fn(state: TrainState, batch: dict):
        state.opt_state.zero_grad(set_to_none=True)
        logits, _ = forward(state.params, cfg, batch["tokens"], remat=remat)
        loss = cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
        loss.backward()
        norm = apply_gradients(state)
        return state, {"loss": float(loss.detach()), "grad_norm": float(norm)}

    return step_fn


__all__ = ["OptimizerSpec", "TrainState", "apply_gradients", "default_optimizer",
           "global_norm", "init_train_state", "make_train_step", "sgd"]
