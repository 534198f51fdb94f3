"""The train step (port of ``llm_consensus_tpu/train/step.py``), on one
device or over a mesh.

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
    leaf requiring grad; the optimizer updates them in place (the JAX step
    donates the previous state for the same reason).
  * **Over a mesh** (``mesh=``, parallel/mesh.py): every position holds its
    shard of the tree (parallel/sharding.py ``param_specs``: tp/ep split,
    replicated over dp and sp) as its own leaves on its own device. Each
    ``dp`` row runs models/transformer.py ``forward_sharded`` on its slice
    of the batch, its loss weighted by its share of the batch's counted
    positions, so the rows' losses sum to the whole batch's mean; then
    every leaf's gradient is summed over the positions that hold the same
    block (the dp all-reduce, and the tp sum of a replicated leaf such as a
    norm, whose gradient each shard's compute gives a part of), in process
    and, when the mesh spans every process of a ``torch.distributed`` group
    (parallel/distributed.py ``hybrid_mesh``), through that group (NCCL for
    CUDA tensors, gloo on the CPU). The clip's norm counts each block once;
    replicas take identical updates and stay equal. Departures: ``sp``
    positions hold replicas and compute nothing (JAX shards the step's
    activations over ``sp``); the optimizer's moments follow their
    parameters' shards (JAX partitions them over ``dp`` as well;
    flywheel/distill.py ``opt_state_shardings`` gives those specs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, forward, forward_sharded, init_params, param_leaves)
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
    params: Optional[dict]  # the whole tree; None over a mesh (see tree())
    optimizer: OptimizerSpec
    opt_state: torch.optim.Optimizer = field(repr=False)
    mesh: object = None
    shards: Optional[list] = field(default=None, repr=False)  # one tree per position
    specs: Optional[dict] = field(default=None, repr=False)

    def leaves(self) -> list:
        if self.mesh is None:
            return [w for _name, w in param_leaves(self.params)]
        return [w for sh in self.shards if sh is not None for _n, w in param_leaves(sh)]

    def tree(self) -> dict:
        """The whole parameter tree (a mesh state's shards joined on the
        first position's device, detached)."""
        if self.mesh is None:
            return self.params
        from llm_consensus_tpu_torch.parallel.sharding import gather_tree

        with torch.no_grad():
            return gather_tree(self.shards, self.specs, self.mesh)

    def groups(self, cfg: ModelConfig) -> list:
        """``(dp index, ShardGroup)`` of every dp row this process holds."""
        out = []
        for d in range(self.mesh.shape.get("dp", 1)):
            if self.shards[self.mesh.flat_index(dp=d)] is not None:
                out.append((d, ShardGroup(cfg, self.mesh, self.shards, self.specs,
                                          {"dp": d, "sp": 0})))
        return out


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
                     params: Optional[dict] = None, mesh=None) -> TrainState:
    """Parameters (random from ``seed`` on the device, or a copy of
    ``params``) and the optimizer's state over them. ``device=None`` is the
    current CUDA card (raises without one). With ``mesh`` (``device`` then
    None) the tree is drawn on the first position's device and split, one
    shard per position this process drives (parallel/sharding.py)."""
    optimizer = optimizer or default_optimizer()
    if mesh is not None:
        from llm_consensus_tpu_torch.parallel.mesh import _process_index
        from llm_consensus_tpu_torch.parallel.sharding import param_specs, shard_pytree

        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if params is None:
            params = init_params(cfg, seed, device=mesh.devices.flat[0].torch_device,
                                 dtype=dtype)
        me = _process_index()
        mine = [i for i, d in enumerate(mesh.devices.flat) if d.process_index == me]
        specs = param_specs(cfg, mesh)
        with torch.no_grad():
            shards = [None if sh is None else _trainable(sh, copy=False)
                      for sh in shard_pytree(params, specs, mesh, positions=mine)]
        leaves = [w for sh in shards if sh is not None for _n, w in param_leaves(sh)]
        return TrainState(step=0, params=None, optimizer=optimizer,
                          opt_state=optimizer.build(leaves), mesh=mesh, shards=shards,
                          specs=specs)
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


def _spec_leaves(specs: dict, prefix: str = ""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _block_groups(state: TrainState) -> list:
    """Every parameter leaf's copies grouped by block: ``[(name, [its leaf
    on each local position holding that block])]``, in one order on every
    process (a block is a leaf's coordinates on the axes its spec splits)."""
    mesh = state.mesh
    specs = dict(_spec_leaves(state.specs))
    local = [(flat, dict(param_leaves(sh))) for flat, sh in enumerate(state.shards)
             if sh is not None]
    out = []
    for name in local[0][1]:
        spec = specs[name]
        axes = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
        blocks: dict = {}
        for flat, leaves in local:
            c = mesh.coords(flat)
            blocks.setdefault(tuple(c[a] for a in mesh.axis_names if a in axes), []).append(
                leaves[name])
        for b in sorted(blocks):
            out.append((name, blocks[b]))
    return out


def _spans_group(mesh) -> bool:
    """True when ``mesh`` spans every process of an initialized
    ``torch.distributed`` group (its dp rows then all-reduce through it)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    return {d.process_index for d in mesh.devices.flat} == set(range(dist.get_world_size()))


def group_value(mesh, value: torch.Tensor) -> float:
    """A loss term summed over the processes a mesh spans (each process's
    :func:`sharded_loss` holds its own rows' part), as a float."""
    import torch.distributed as dist

    value = value.detach().clone()
    if _spans_group(mesh):
        dist.all_reduce(value)
    return float(value)


def reduce_gradients(state: TrainState) -> list:
    """Sum each block's gradient over the positions holding it (in process,
    then over the process group when the mesh spans it) and give every copy
    the sum; returns one gradient per block (the clip's norm counts each
    once)."""
    import torch.distributed as dist

    from llm_consensus_tpu_torch.parallel.sharding import reduce_sum

    through_group = _spans_group(state.mesh)
    unique = []
    for _name, copies in _block_groups(state):
        total = reduce_sum([w.grad if w.grad is not None else torch.zeros_like(w)
                            for w in copies])
        if through_group:
            dist.all_reduce(total)
        for w in copies:
            w.grad = total.to(w.device, copy=True)
        unique.append(total)
    return unique


def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip (when the optimizer clips) and step; returns the unclipped
    global gradient norm. A mesh state's gradients are reduced first
    (:func:`reduce_gradients`)."""
    if state.mesh is not None:
        norm = global_norm(reduce_gradients(state))
        clip = state.optimizer.clip_norm
        if clip is not None:
            coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
            for w in state.leaves():
                w.grad.mul_(coef.to(w.grad.device))
        state.opt_state.step()
        state.step += 1
        return norm
    leaves = state.leaves()
    if state.optimizer.clip_norm is not None:
        norm = torch.nn.utils.clip_grad_norm_(leaves, state.optimizer.clip_norm)
    else:
        norm = global_norm([w.grad if w.grad is not None else torch.zeros_like(w)
                            for w in leaves])
    state.opt_state.step()
    state.step += 1
    return norm


def sharded_loss(state: TrainState, cfg: ModelConfig, batch: dict, loss_fn, remat: bool,
                 extra: Optional[dict] = None):
    """The whole batch's loss over a mesh state: each dp row this process
    holds runs its rows of ``batch`` through ``forward_sharded`` and
    ``loss_fn(logits, rows, extra_rows) -> (masked mean, {aux means})``,
    weighted by its rows' share of the batch's counted positions. Returns
    ``(loss, aux)`` summed on the first position's device (this process's
    rows: the gradient all-reduce completes the rest)."""
    b = batch["tokens"].shape[0]
    dp = state.mesh.shape.get("dp", 1)

    def counted(part: dict) -> float:
        m = part.get("mask")
        return float(m.float().sum()) if m is not None else float(part["tokens"].numel())

    total = max(counted(batch), 1.0)
    dev0 = state.mesh.devices.flat[0].torch_device
    loss, aux = None, {}
    for d, group in state.groups(cfg):
        sl = slice(d * b // dp, (d + 1) * b // dp)  # a batch dp does not divide: uneven rows
        if sl.start == sl.stop:
            continue
        part = {k: v[sl].to(group.root) for k, v in batch.items()}
        more = {k: v[sl].to(group.root) for k, v in (extra or {}).items()}
        w = counted(part) / total
        l_d, aux_d = loss_fn(forward_sharded(group, part["tokens"], remat=remat), part, more)
        l_d = l_d.to(dev0) * w
        loss = l_d if loss is None else loss + l_d
        for k, v in aux_d.items():
            aux[k] = aux.get(k, 0.0) + v.detach().to(dev0) * w
    return loss, aux


def make_train_step(cfg: ModelConfig, remat: bool = True, mesh=None):
    """``step_fn(state, batch) -> (state, metrics)``: ``batch`` is
    ``{"tokens", "targets", "mask"}`` each [B, T] (tensors on the state's
    device; over a mesh, on any device: each dp row takes its rows);
    metrics carry ``loss`` and ``grad_norm`` as floats. The state is
    updated in place, with the optimizer it was built with, and returned
    (the JAX step takes the optimizer as an argument). ``mesh`` must be the
    state's."""

    def step_fn(state: TrainState, batch: dict):
        if state.mesh is not mesh:
            raise ValueError("the step's mesh is not the state's")
        state.opt_state.zero_grad(set_to_none=True)
        if mesh is not None:
            loss, _aux = sharded_loss(state, cfg, batch, lambda lg, part, _more: (
                cross_entropy_loss(lg, part["targets"], part.get("mask")), {}), remat)
            loss.backward()
            norm = apply_gradients(state)
            return state, {"loss": group_value(mesh, loss), "grad_norm": float(norm)}
        logits, _ = forward(state.params, cfg, batch["tokens"], remat=remat)
        loss = cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
        loss.backward()
        norm = apply_gradients(state)
        return state, {"loss": float(loss.detach()), "grad_norm": float(norm)}

    return step_fn


__all__ = ["OptimizerSpec", "TrainState", "apply_gradients", "default_optimizer",
           "global_norm", "group_value", "init_train_state", "make_train_step",
           "reduce_gradients", "sgd", "sharded_loss"]
