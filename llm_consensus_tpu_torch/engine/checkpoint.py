"""Checkpoint loading for the port's engines (port of the HF half of
``llm_consensus_tpu/engine/checkpoint.py``).

  * **HuggingFace safetensors** directories import into the port's
    parameter layout: HF linear weights are [out, in] and become [in, out],
    per-layer tensors stack on a leading layer axis, and Mixtral's experts
    stack on axis 1 of each layer ([L, E, in, out]). Gemma's norm weights
    import verbatim (the port's ``rms_norm`` applies the same ``1 + w``
    offset); tied embeddings have no ``lm_head``.
  * **Orbax** directories (the JAX package's native format) cannot be read
    here: :func:`try_load_params` raises rather than serving random weights
    in their place.
  * A missing directory, or one with neither, gives None: the caller
    random-initializes, as the JAX package's failed load does.
  * **Sharded loading** (the path that makes a checkpoint larger than one
    card placeable): with a mesh of more than one position,
    :func:`try_load_params` reads each position's block of each tensor
    straight into that position's shard (:func:`load_hf_safetensors_sharded`),
    so no device or host ever holds the whole tree.
  * :func:`save_hf_safetensors` writes a parameter tree back in the HF
    layout (one ``model.safetensors`` file): the flywheel's distilled
    checkpoints, which the loader and ``GPUProvider.swap_weights`` read
    (the JAX package writes Orbax there).

The safetensors format is read here with torch alone (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets, then the raw little-endian bytes), so no ``safetensors`` package
is needed. F32, F16 and BF16 tensors are read one at a time and placed on
the device one layer at a time; with ``quant`` each matmul weight is
quantized as its layer lands, so the peak is the quantized tree plus one
layer of one leaf (one layer's experts for Mixtral) and the LM head.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import struct
from typing import Optional, Sequence

import torch

from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.ops.quant import (
    INT4_GROUP, QUANT_KEYS, WEIGHT_MODES, _quantize, quantize_weight, stack_layers)

# HF parameter name templates per port parameter, for llama-family layouts
# (llama/mistral/qwen2; gemma shares them; mixtral's experts separately).
_HF_LAYER_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "bq": "model.layers.{i}.self_attn.q_proj.bias",
    "bk": "model.layers.{i}.self_attn.k_proj.bias",
    "bv": "model.layers.{i}.self_attn.v_proj.bias",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}

_HF_MOE_MAP = {
    "w_router": "model.layers.{i}.block_sparse_moe.gate.weight",
    "w_gate": "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    "w_down": "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
    "w_up": "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
}

# HF stores linear weights [out, in]; the port uses [in, out].
_HF_TRANSPOSE = {
    "attn_norm": False, "mlp_norm": False,
    "wq": True, "wk": True, "wv": True, "wo": True,
    "bq": False, "bk": False, "bv": False,
    "w_gate": True, "w_up": True, "w_down": True, "w_router": True,
}

# The files by which the JAX package recognizes an Orbax checkpoint.
_ORBAX_MARKERS = ("_METADATA", "d", "manifest.ocdbt")

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsDir:
    """Every ``*.safetensors`` file of a directory, by tensor name; each
    tensor is read from its file on request (CPU, its stored dtype)."""

    def __init__(self, path: str):
        self._where: dict[str, tuple[str, int, dict]] = {}
        for fname in sorted(f for f in os.listdir(path) if f.endswith(".safetensors")):
            fpath = os.path.join(path, fname)
            with open(fpath, "rb") as f:
                (n,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(n))
            header.pop("__metadata__", None)
            for name, info in header.items():
                self._where[name] = (fpath, 8 + n, info)

    def keys(self) -> list[str]:
        return list(self._where)

    def get(self, name: str) -> torch.Tensor:
        return self.get_slice(name, ())

    def get_slice(self, name: str, index: Sequence[slice]) -> torch.Tensor:
        """The block ``index`` of a tensor (one step-1 slice per leading
        dim, the dims past them whole), read as the row-major byte ranges
        the block covers straight into the block's own buffer: no buffer of
        the whole tensor exists."""
        try:
            fpath, base, info = self._where[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} is not in the checkpoint") from None
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']!r}")
        shape = list(info["shape"])
        if len(index) > len(shape) or any(sl.step not in (None, 1) for sl in index):
            raise ValueError(f"{name}: block {index} of a tensor of shape {shape}")
        bounds = ([sl.indices(n)[:2] for sl, n in zip(index, shape)]
                  + [(0, n) for n in shape[len(index):]])
        out_shape = [max(0, hi - lo) for lo, hi in bounds]
        # Dims from `whole` on are entire, so each run of the block spans
        # dim whole - 1's range of them, contiguous in the file.
        whole = len(shape)
        while whole > 0 and bounds[whole - 1] == (0, shape[whole - 1]):
            whole -= 1
        strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        item = torch.empty((), dtype=dtype).element_size()
        k = max(whole - 1, 0)
        run = (out_shape[k] * strides[k] if shape else 1) * item
        buf = bytearray(math.prod(out_shape) * item)
        if not buf:
            return torch.empty(out_shape, dtype=dtype)
        view, at = memoryview(buf), 0
        start = base + info["data_offsets"][0]
        with open(fpath, "rb") as f:
            for outer in itertools.product(*(range(lo, hi) for lo, hi in bounds[:k])):
                elem = sum(i * st for i, st in zip(outer, strides)) + (
                    bounds[k][0] * strides[k] if shape else 0)
                f.seek(start + elem * item)
                if f.readinto(view[at:at + run]) != run:
                    raise ValueError(f"{name}: truncated data in {fpath}")
                at += run
        return torch.frombuffer(buf, dtype=dtype).reshape(out_shape)


def load_hf_safetensors(cfg: ModelConfig, path: str, *, device: torch.device,
                        dtype: Optional[torch.dtype] = torch.bfloat16,
                        quant: Optional[str] = None) -> dict:
    """Import an HF safetensors checkpoint into the port's parameter layout
    on ``device`` in ``dtype`` (the JAX package's ``load_hf_safetensors``
    tree; None keeps each tensor's stored dtype). With ``quant`` ("int8" |
    "int4") every matmul weight is quantized as it lands."""
    if quant not in (None, *WEIGHT_MODES):
        raise ValueError(f"unknown quant mode {quant!r}")
    src = SafetensorsDir(path)

    def get(name: str, transpose: bool) -> torch.Tensor:
        t = src.get(name)
        return (t.t() if transpose else t).to(device=device, dtype=dtype).contiguous()

    def stack(param: str, template: str, n_experts: int = 0):
        """One tensor per layer (Mixtral's experts stacked on axis 1 of
        each), stacked on axis 0 one layer at a time and, for a matmul
        weight with ``quant``, quantized as each layer lands."""
        flip = _HF_TRANSPOSE[param]

        def layer(i: int) -> torch.Tensor:
            if not n_experts:
                return get(template.format(i=i), flip)
            return torch.stack([get(template.format(i=i, e=e), flip) for e in range(n_experts)])

        return stack_layers(cfg.n_layers, layer, quant if param in QUANT_KEYS else None)

    layers = {p: stack(p, _HF_LAYER_MAP[p])
              for p in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo")}
    if cfg.qkv_bias:
        for p in ("bq", "bk", "bv"):
            layers[p] = stack(p, _HF_LAYER_MAP[p])
    if cfg.is_moe:
        layers["w_router"] = stack("w_router", _HF_MOE_MAP["w_router"])
        for p in ("w_gate", "w_up", "w_down"):
            layers[p] = stack(p, _HF_MOE_MAP[p], cfg.n_experts)
    else:
        for p in ("w_gate", "w_up", "w_down"):
            layers[p] = stack(p, _HF_LAYER_MAP[p])

    params = {
        "embed": get("model.embed_tokens.weight", False),
        "final_norm": get("model.norm.weight", False),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        head = get("lm_head.weight", True)
        params["lm_head"] = quantize_weight(head, quant) if quant is not None else head
    return params


def _row_blocks_amax(param: str, blocks: dict, index: dict, rows: int) -> dict:
    """Per position, the column maxima over the WHOLE weight's rows from
    the positions' row blocks (``blocks`` and their ``index`` by position,
    the rows being dim -2): the maxima of the blocks that share the other
    dims, each block's on its own device."""
    groups: dict = {}
    for p, idx in index.items():
        key = tuple((sl.start, sl.stop) for d, sl in enumerate(idx) if d != len(idx) - 2)
        groups.setdefault(key, {}).setdefault((idx[-2].start, idx[-2].stop), []).append(p)
    out = {}
    for members in groups.values():
        if sum(hi - lo for lo, hi in members) != rows:
            raise ValueError(f"{param}: int8 scales need every row block of the weight; "
                             f"the positions hold {sorted(members)} of {rows} rows")
        holders = [ps[0] for ps in members.values()]  # one position per distinct block
        amax = None
        for p in holders:
            part = blocks[p].abs().amax(dim=-2, keepdim=True).to(blocks[holders[0]].device)
            amax = part if amax is None else torch.maximum(amax, part)
        for ps in members.values():
            for p in ps:
                out[p] = amax.to(blocks[p].device)
    return out


def load_hf_safetensors_sharded(cfg: ModelConfig, path: str, mesh, *,
                                dtype: Optional[torch.dtype] = torch.bfloat16,
                                quant: Optional[str] = None,
                                positions: Optional[Sequence[int]] = None) -> list:
    """Import an HF safetensors checkpoint straight into one shard per mesh
    position, ``parallel/sharding.py`` ``shard_pytree``'s list (the
    positions outside ``positions`` None), reading for each position only
    its block of each tensor (:meth:`SafetensorsDir.get_slice`) onto its
    device: the whole tree never exists, on the host or on a device (the
    JAX package's ``load_hf_safetensors_sharded``). Layers and experts
    stack per shard, one layer at a time. With ``quant`` each matmul weight
    quantizes as its layer's blocks land, to the codes and scales the whole
    leaf's quantization gives: an int8 weight whose rows split takes its
    per-column scales from every position's rows (so ``positions`` must
    hold every row block), an int4 one needs its shard's rows in whole
    groups."""
    from llm_consensus_tpu_torch.parallel.sharding import (
        block_index, param_shapes, param_specs)

    if quant not in (None, *WEIGHT_MODES):
        raise ValueError(f"unknown quant mode {quant!r}")
    src = SafetensorsDir(path)
    shapes, specs = param_shapes(cfg), param_specs(cfg, mesh)
    wanted = list(range(mesh.size)) if positions is None else list(positions)
    devices = {p: mesh.devices.flat[p].torch_device for p in wanted}
    coords = {p: mesh.coords(p) for p in wanted}
    shards = {p: {"layers": {}} for p in wanted}

    def read(name: str, idx: tuple, flip: bool, p: int) -> torch.Tensor:
        """One block in the port's orientation on position ``p``'s device
        (HF linear weights are [out, in]: the block is read transposed)."""
        if flip:
            t = src.get_slice(name, idx[:-2] + (idx[-1], idx[-2])).transpose(-1, -2)
        else:
            t = src.get_slice(name, idx)
        return t.to(device=devices[p], dtype=dtype or t.dtype).contiguous()

    top = [("embed", "model.embed_tokens.weight", False),
           ("final_norm", "model.norm.weight", False)]
    if not cfg.tie_embeddings:
        top.append(("lm_head", "lm_head.weight", True))
    for name, hf_name, flip in top:
        for p in wanted:
            t = read(hf_name, block_index(shapes[name], specs[name], mesh, coords[p]), flip, p)
            # The head splits its columns (the vocabulary) only: quantized alone.
            shards[p][name] = quantize_weight(t, quant) if name == "lm_head" and quant else t

    for param, shape in shapes["layers"].items():
        spec = specs["layers"][param]
        experts = cfg.is_moe and param in ("w_gate", "w_up", "w_down")
        template = (_HF_MOE_MAP if experts or param == "w_router" else _HF_LAYER_MAP)[param]
        flip = _HF_TRANSPOSE[param]
        mode = quant if param in QUANT_KEYS else None
        index = {p: block_index(shape, spec, mesh, coords[p]) for p in wanted}

        def block(p: int, i: int, index=index, template=template, flip=flip, experts=experts):
            idx = index[p][1:]  # the layer axis is never split
            if not experts:
                return read(template.format(i=i), idx, flip, p)
            return torch.stack([read(template.format(i=i, e=e), idx[1:], flip, p)
                                for e in range(idx[0].start, idx[0].stop)])

        rows = index[wanted[0]][-2]
        rows_split = mode is not None and rows != slice(0, shape[-2])
        if mode == "int4" and rows_split and (rows.stop - rows.start) % INT4_GROUP:
            raise ValueError(f"{param}: int4 groups of {INT4_GROUP} rows do not divide its "
                             f"shard's {rows.stop - rows.start} rows")
        if mode != "int8" or not rows_split:
            for p in wanted:
                shards[p]["layers"][param] = stack_layers(
                    cfg.n_layers, lambda i, p=p: block(p, i), mode)
            continue
        # A row-split int8 weight: every position's block of a layer, then
        # one set of column maxima from all of them.
        stacks: dict = {}
        for i in range(cfg.n_layers):
            blocks = {p: block(p, i) for p in wanted}
            amax = _row_blocks_amax(param, blocks, index, shape[-2])
            for p, blk in blocks.items():
                part = _quantize(blk, amax[p])
                if p not in stacks:
                    stacks[p] = {k: torch.empty((cfg.n_layers, *v.shape), dtype=v.dtype,
                                                device=v.device) for k, v in part.items()}
                for k, v in part.items():
                    stacks[p][k][i].copy_(v)
            del blocks, amax
        for p in wanted:
            shards[p]["layers"][param] = stacks[p]

    out: list = [None] * mesh.size
    for p in wanted:
        out[p] = shards[p]
    return out


def try_load_params(cfg: ModelConfig, path: Optional[str], *,
                    device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = torch.bfloat16,
                    quant: Optional[str] = None, mesh=None):
    """Parameters from ``path``: a directory of ``*.safetensors`` loads;
    a missing path or directory gives None (random init), as does a
    directory holding neither format; an Orbax directory raises
    ``ValueError`` (the port cannot read it and must not quietly serve
    random weights instead). With a ``mesh`` of more than one position the
    checkpoint restores straight into one shard per position
    (:func:`load_hf_safetensors_sharded`), in the engine's form: a shard on
    every position of the ``dp`` axis's first index, None elsewhere (one
    stream is one batch row), which ``Engine(params=, mesh=)`` takes as
    they are. Otherwise the whole tree lands on ``device`` (a one-position
    mesh's device when given)."""
    if not path or not os.path.isdir(path):
        return None
    entries = os.listdir(path)
    sharded = mesh is not None and mesh.size > 1
    if any(e.endswith(".safetensors") for e in entries):
        if sharded:
            keep = [i for i in range(mesh.size) if mesh.coords(i).get("dp", 0) == 0]
            return load_hf_safetensors_sharded(cfg, path, mesh, dtype=dtype, quant=quant,
                                               positions=keep)
        if mesh is not None:
            device = mesh.devices.flat[0].torch_device
        if device is None:
            raise ValueError("try_load_params needs a device or a mesh")
        return load_hf_safetensors(cfg, path, device=device, dtype=dtype, quant=quant)
    if any(e in _ORBAX_MARKERS or e.startswith("ocdbt") for e in entries):
        raise ValueError(
            f"{path}: an Orbax checkpoint, which the PyTorch port cannot read; "
            "convert it to HF safetensors")
    return None


def hf_tensors(cfg: ModelConfig, params: dict, dtype: Optional[torch.dtype] = None) -> dict:
    """A dense parameter tree (``init_params`` layout) as HF-named host
    tensors, the inverse of :func:`load_hf_safetensors`: [in, out] matmul
    weights back to [out, in], one tensor per layer (and per expert), in
    ``dtype`` (None: each leaf's own)."""
    def host(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        t = t.detach()
        t = t.t() if transpose else t
        return t.to(device="cpu", dtype=dtype or t.dtype).contiguous()

    out = {"model.embed_tokens.weight": host(params["embed"]),
           "model.norm.weight": host(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head.weight"] = host(params["lm_head"], True)
    for name, stacked in params["layers"].items():
        if isinstance(stacked, dict):
            raise ValueError(f"{name}: a quantized tree has no HF layout to write")
        moe = cfg.is_moe and name in ("w_gate", "w_up", "w_down")
        template = (_HF_MOE_MAP if moe or name == "w_router" else _HF_LAYER_MAP)[name]
        for i in range(cfg.n_layers):
            if moe:
                for e in range(cfg.n_experts):
                    out[template.format(i=i, e=e)] = host(stacked[i][e], _HF_TRANSPOSE[name])
            else:
                out[template.format(i=i)] = host(stacked[i], _HF_TRANSPOSE[name])
    return out


def write_safetensors(path: str, tensors: dict) -> None:
    """One safetensors file (an 8-byte little-endian header length, the
    JSON header, the raw bytes), flushed and fsynced before it returns."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            f.write(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        f.flush()
        os.fsync(f.fileno())


def save_hf_safetensors(cfg: ModelConfig, params: dict, path: str,
                        dtype: Optional[torch.dtype] = None) -> None:
    """Write ``params`` into the directory ``path`` as one HF
    ``model.safetensors`` (what :func:`try_load_params` reads back)."""
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), hf_tensors(cfg, params, dtype))
