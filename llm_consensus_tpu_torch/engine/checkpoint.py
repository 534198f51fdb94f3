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

import json
import os
import struct
from typing import Optional

import torch

from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.ops.quant import (
    QUANT_KEYS, WEIGHT_MODES, quantize_weight, stack_layers)

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
        try:
            fpath, base, info = self._where[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} is not in the checkpoint") from None
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        buf = bytearray(end - begin)
        with open(fpath, "rb") as f:
            f.seek(base + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{name}: truncated data in {fpath}")
        shape = info["shape"]
        if not buf:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


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


def try_load_params(cfg: ModelConfig, path: Optional[str], *, device: torch.device,
                    dtype: Optional[torch.dtype] = torch.bfloat16,
                    quant: Optional[str] = None) -> Optional[dict]:
    """Parameters from ``path``: a directory of ``*.safetensors`` loads;
    a missing path or directory gives None (random init), as does a
    directory holding neither format; an Orbax directory raises
    ``ValueError`` (the port cannot read it and must not quietly serve
    random weights instead)."""
    if not path or not os.path.isdir(path):
        return None
    entries = os.listdir(path)
    if any(e.endswith(".safetensors") for e in entries):
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
