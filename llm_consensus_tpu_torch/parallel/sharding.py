"""Sharding specs for parameters and KV caches, the shards themselves, and
the in-process collectives (port of ``llm_consensus_tpu/parallel/sharding.py``).

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names, or ``None`` (replicated), leaf for leaf the JAX
``PartitionSpec`` tree (``tuple(P(None, "tp")) == (None, "tp")``).
Megatron-style tensor parallelism, as in JAX: QKV projections are
column-parallel (heads over ``tp``), the output projection row-parallel,
the MLP splits its hidden dim, the vocabulary splits over ``tp``, and MoE
experts split over ``ep`` (or ``tp`` without an ``ep`` axis), their hidden
dim over ``tp`` too when both exist. A dim its axis does not divide
degrades to replicated.

Where JAX declares placements and lets GSPMD insert the collectives, the
port materializes one shard per mesh position (:func:`shard_pytree`, on
that position's ``torch.device``) and the model reduces partial sums
itself (models/transformer.py ``forward_sharded``) with the collectives
here: each is one code path that copies to the first tensor's device,
reduces there and copies back, so the same code runs on the CPU, on one
card with virtual positions, and on several cards.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llm_consensus_tpu_torch.parallel.mesh import Mesh

# -- specs ----------------------------------------------------------------------


def _axis(mesh: Optional[Mesh], name: str, dim: int) -> Optional[str]:
    """Use mesh axis ``name`` for a tensor dim only if present, > 1 and
    dividing ``dim``."""
    if mesh is None or name not in mesh.axis_names:
        return None
    size = mesh.shape[name]
    if size == 1 or dim % size != 0:
        return None
    return name


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (``init_params`` layout)."""
    from llm_consensus_tpu_torch.models.transformer import _layer_shapes

    shapes = {"embed": (cfg.vocab_size, cfg.d_model), "final_norm": (cfg.d_model,),
              "layers": _layer_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def param_specs(cfg, mesh: Optional[Mesh] = None) -> dict:
    """Spec tree matching ``init_params(cfg)``. ``mesh=None`` gives the
    canonical specs; with a mesh, a dim its axis does not divide degrades
    to replicated.

    The JAX package replicates the vocabulary on 3-axis ``dp x tp x sp``
    meshes (a jax 0.4 GSPMD miscompile of the train step it works around);
    the port keeps the same specs so the two trees stay equal leaf for leaf."""
    dh = cfg.head_dim
    tp_q = _axis(mesh, "tp", cfg.n_heads * dh)
    tp_kv = _axis(mesh, "tp", cfg.n_kv_heads * dh)
    tp_ff = _axis(mesh, "tp", cfg.d_ff)
    tp_vocab = _axis(mesh, "tp", cfg.vocab_size)
    if mesh is not None and all(mesh.shape.get(a, 1) > 1 for a in ("dp", "tp", "sp")):
        tp_vocab = None
    layers: dict = {
        "attn_norm": (None, None), "mlp_norm": (None, None),
        "wq": (None, None, tp_q), "wk": (None, None, tp_kv), "wv": (None, None, tp_kv),
        "wo": (None, tp_q, None),
    }
    if cfg.qkv_bias:
        layers["bq"] = (None, tp_q)
        layers["bk"] = (None, tp_kv)
        layers["bv"] = (None, tp_kv)
    if cfg.is_moe:
        ep_name = "ep" if (mesh is None or "ep" in mesh.axis_names) else "tp"
        ep = _axis(mesh, ep_name, cfg.n_experts)
        layers["w_router"] = (None, None, None)
        inner = tp_ff if ep != "tp" else None
        layers["w_gate"] = (None, ep, None, inner)
        layers["w_up"] = (None, ep, None, inner)
        layers["w_down"] = (None, ep, inner, None)
    else:
        layers["w_gate"] = (None, None, tp_ff)
        layers["w_up"] = (None, None, tp_ff)
        layers["w_down"] = (None, tp_ff, None)
    specs = {"embed": (tp_vocab, None), "final_norm": (None,), "layers": layers}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, tp_vocab)
    return specs


def _tree_map(fn, *trees):
    """``fn`` over matching leaves of plain nested dicts (shapes, specs)."""
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or set(t) != set(first) for t in trees[1:]):
            raise ValueError(f"trees differ: {[sorted(t) for t in trees]}")
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def opt_moment_specs(cfg, mesh: Optional[Mesh] = None) -> dict:
    """Cross-replica specs for the optimizer's moment buffers (ZeRO-1
    style, the JAX rule): each moment takes its parameter's spec, then its
    first still-replicated dim that ``dp`` divides shards over ``dp``."""
    specs = param_specs(cfg, mesh)
    dp = mesh.shape["dp"] if mesh is not None and mesh.shape.get("dp", 1) > 1 else None

    def widen(shape, spec):
        if dp is None:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, ax in enumerate(entries):
            if ax is None and shape[i] % dp == 0:
                entries[i] = "dp"
                return tuple(entries)
        return spec

    return _tree_map(widen, param_shapes(cfg), specs)


def cache_specs(cfg, mesh: Optional[Mesh] = None, batch: int = 1) -> dict:
    """Spec tree matching ``init_kv_cache``'s [L, B, S, Hkv, dh] pair: KV
    heads over ``tp`` when it divides them, batch over ``dp`` when it
    divides the batch."""
    spec = (None, _axis(mesh, "dp", batch), None, _axis(mesh, "tp", cfg.n_kv_heads), None)
    return {"k": spec, "v": spec}


def abstract_param_bytes(cfg, mesh: Mesh, itemsize: int = 2) -> tuple[int, int]:
    """``(total_bytes, tp_sharded_bytes)`` of ``cfg``'s parameter tree
    (bf16 unless ``itemsize`` says otherwise) on ``mesh``: shapes and specs
    only, nothing allocated."""
    acc = {"total": 0, "sharded": 0}

    def tally(shape, spec):
        nbytes = int(np.prod(shape)) * itemsize
        acc["total"] += nbytes
        if any(ax is not None for ax in spec):
            acc["sharded"] += nbytes

    _tree_map(tally, param_shapes(cfg), param_specs(cfg, mesh))
    return acc["total"], acc["sharded"]


# -- shards ---------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _slice(t: torch.Tensor, spec: Sequence, mesh: Mesh, coords: dict) -> torch.Tensor:
    """This position's block of ``t`` under ``spec``."""
    idx = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            idx.append(slice(None))
            continue
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not divide by {n}")
        w = t.shape[dim] // n
        idx.append(slice(i * w, (i + 1) * w))
    return t[tuple(idx)]


def _leaf_parts(leaf, spec) -> list:
    """(tensor, its own spec) pairs of a leaf: a plain tensor, an int8
    weight ``{"q8", "s"}`` (codes and scales on the weight's dims), an int4
    weight ``{"q4", "s"}`` ([.., K/g, g/2, N]: the row split moves to the
    groups) or an int8 cache side ``{"q8": [L,B,S,H,dh], "s": [L,B,H,S]}``."""
    if not isinstance(leaf, dict):
        return [(None, leaf, tuple(spec))]
    if "q4" in leaf:
        s4 = tuple(spec[:-1]) + (None, spec[-1])
        return [("q4", leaf["q4"], s4), ("s", leaf["s"], s4)]
    if leaf["q8"].dim() == leaf["s"].dim() + 1:  # an int8 cache side
        return [("q8", leaf["q8"], tuple(spec)),
                ("s", leaf["s"], (spec[0], spec[1], spec[3], spec[2]))]
    # The per-column scales [.., 1, N] stay whole along the rows.
    return [("q8", leaf["q8"], tuple(spec)), ("s", leaf["s"], tuple(spec[:-2]) + (None, spec[-1]))]


def _place(block: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``block`` on ``dev`` that owns its storage."""
    out = torch.empty(block.shape, dtype=block.dtype, device=dev)
    return out.copy_(block)


def shard_pytree(tree: dict, specs: dict, mesh: Mesh,
                 positions: Optional[Sequence[int]] = None) -> list:
    """One shard of ``tree`` per mesh position (``mesh.devices.flat``
    order), each on its position's ``torch.device`` and owning its storage
    (a cache shard is a contiguous tensor of its heads, not a strided
    view). ``positions`` limits the work to those flat indices; the others
    are None."""
    wanted = range(mesh.size) if positions is None else positions
    out: list = [None] * mesh.size
    for flat in wanted:
        coords = mesh.coords(flat)
        dev = mesh.devices.flat[flat].torch_device

        def one(leaf, spec, coords=coords, dev=dev):
            parts = _leaf_parts(leaf, spec)
            if parts[0][0] is None:
                return _place(_slice(leaf, spec, mesh, coords), dev)
            return {k: _place(_slice(t, s, mesh, coords), dev) for k, t, s in parts}

        out[flat] = _tree_map_leaves(one, tree, specs)
    return out


def _tree_map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree whose leaves may be quantized dicts."""
    if isinstance(tree, dict) and not _is_leaf_dict(tree):
        return {k: _tree_map_leaves(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def _is_leaf_dict(d: dict) -> bool:
    return "q8" in d or "q4" in d


def make_shard_fn(cfg, mesh: Mesh) -> Callable:
    """``shard(tree) -> list of shards``: a parameter tree (has ``embed``)
    by :func:`param_specs`, a KV cache (``{"k", "v"}``) by
    :func:`cache_specs`."""

    def shard(tree):
        if isinstance(tree, dict) and "embed" in tree:
            return shard_pytree(tree, param_specs(cfg, mesh), mesh)
        if isinstance(tree, dict) and set(tree) == {"k", "v"}:
            return shard_pytree(tree, cache_specs(cfg, mesh), mesh)
        raise ValueError(f"unrecognized pytree with keys {list(tree)}")

    return shard


def gather_tree(shards: Sequence[dict], specs: dict, mesh: Mesh) -> dict:
    """The whole tree back from one shard per position (the inverse of
    :func:`shard_pytree`), on the first position's device."""
    dev = mesh.devices.flat[0].torch_device

    def walk(spec_tree, parts):
        first = parts[0]
        if isinstance(first, dict) and not _is_leaf_dict(first):
            return {k: walk(spec_tree[k], [p[k] for p in parts]) for k in first}
        if not isinstance(first, dict):
            return _join(parts, tuple(spec_tree), mesh, dev)
        return {k: _join([p[k] for p in parts], s, mesh, dev)
                for k, _t, s in _leaf_parts(first, spec_tree)}

    return walk(specs, list(shards))


def _join(parts, spec, mesh: Mesh, dev) -> torch.Tensor:
    """One leaf's per-position blocks concatenated along its split dims
    (the blocks at index 0 of every axis the spec does not name)."""

    def build(dim: int, coords: dict) -> torch.Tensor:
        if dim == len(spec):
            return parts[mesh.flat_index(**coords)].to(dev)
        axes = _axes(spec[dim])
        if not axes:
            return build(dim + 1, coords)
        pieces = []
        for combo in itertools.product(*(range(mesh.shape[a]) for a in axes)):
            pieces.append(build(dim + 1, {**coords, **dict(zip(axes, combo))}))
        return torch.cat(pieces, dim=dim)

    return build(0, {})


# -- in-process collectives -------------------------------------------------------


def reduce_sum(tensors: Sequence[torch.Tensor], device: Optional[torch.device] = None
               ) -> torch.Tensor:
    """The sum of per-position partials, in position order, on ``device``
    (default: the first tensor's)."""
    dev = tensors[0].device if device is None else device
    total = tensors[0].to(dev)
    for t in tensors[1:]:
        total = total + t.to(dev)
    return total


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> list:
    """All-reduce over one axis: the sum on the first tensor's device,
    copied back to each tensor's device."""
    total = reduce_sum(tensors)
    return [total.to(t.device) for t in tensors]


def gather(tensors: Sequence[torch.Tensor], dim: int,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-position blocks concatenated along ``dim`` on ``device``
    (default: the first tensor's)."""
    dev = tensors[0].device if device is None else device
    return torch.cat([t.to(dev) for t in tensors], dim=dim)


def all_gather(tensors: Sequence[torch.Tensor], dim: int) -> list:
    """All-gather over one axis: the concatenation on the first tensor's
    device, copied back to each tensor's device."""
    whole = gather(tensors, dim)
    return [whole.to(t.device) for t in tensors]


__all__ = ["abstract_param_bytes", "all_gather", "all_reduce_sum", "cache_specs", "gather",
           "gather_tree", "make_shard_fn", "opt_moment_specs", "param_shapes", "param_specs",
           "reduce_sum", "shard_pytree"]
