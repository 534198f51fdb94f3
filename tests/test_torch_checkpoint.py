"""The port's HF safetensors loader (engine/checkpoint.py) against the JAX
package's and against the ``safetensors`` package.

Synthetic HF-layout checkpoints are written as ``tests/test_hf_golden.py``
writes them (seeded random, real safetensors files). The port's reader must
give exactly what ``safe_open`` gives for F32, F16 and BF16 tensors, and the
port's loaded tree must equal the JAX loader's leaf for leaf, exactly (the
same bytes converted to the same dtype): float32 and bfloat16, for the
llama, qwen2 (biases), gemma (norm offset, tied head) and mixtral (stacked
experts) layouts. Quantized loads equal quantizing the loaded tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine.checkpoint import load_hf_safetensors as jax_load
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu_torch.engine.checkpoint import (
    SafetensorsDir, load_hf_safetensors, try_load_params)
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import param_leaves
from llm_consensus_tpu_torch.ops import quant as tq
from tests.test_hf_golden import _make_hf_checkpoint

CPU = torch.device("cpu")
PRESETS = ["tiny-llama", "tiny-qwen2", "tiny-gemma", "tiny-mixtral"]


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {name.replace(".", "/"): t for name, t in param_leaves(tree)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_reader_equals_safe_open(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn(7, 5, generator=gen).to(dtype),
        "b.bias": torch.randn(3, generator=gen).to(dtype),
        "c.scalar": torch.randn((), generator=gen).to(dtype),
        "d.empty": torch.zeros(0, 4, dtype=dtype),
        "e.cube": torch.randn(2, 3, 4, generator=gen).to(dtype),
    }
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    ours = SafetensorsDir(str(tmp_path))
    assert sorted(ours.keys()) == sorted(tensors)
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        for name in tensors:
            want = f.get_tensor(name)
            got = ours.get(name)
            assert got.dtype == want.dtype == dtype and got.shape == want.shape
            assert torch.equal(got, want), name
    with pytest.raises(KeyError, match="not in the checkpoint"):
        ours.get("missing")


def test_reader_spans_shards(tmp_path):
    from safetensors.torch import save_file

    save_file({"x": torch.ones(2)}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({"y": torch.full((3,), 2.0)}, str(tmp_path / "model-00002-of-00002.safetensors"))
    ours = SafetensorsDir(str(tmp_path))
    assert torch.equal(ours.get("x"), torch.ones(2))
    assert torch.equal(ours.get("y"), torch.full((3,), 2.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_loaded_tree_equals_the_jax_loader(tmp_path, preset, dtype):
    path = str(tmp_path / preset)
    _make_hf_checkpoint(jax_config(preset), path, seed=7)
    want = _flat_jax(jax_load(jax_config(preset), path, dtype=getattr(jnp, dtype)))
    got = _flat_port(load_hf_safetensors(get_config(preset), path, device=CPU,
                                         dtype=getattr(torch, dtype)))
    assert set(got) == set(want)
    for key, arr in want.items():
        t = got[key]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == arr.shape, key
        np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32), err_msg=key)
    if preset == "tiny-qwen2":
        assert got["layers/bq"].abs().sum() > 0
    if preset == "tiny-gemma":
        assert "lm_head" not in got


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-mixtral"])
def test_quantized_load_equals_quantizing_the_loaded_tree(tmp_path, preset, mode):
    """With ``quant`` each leaf is quantized as it lands (the experts layer
    by layer): the same codes as quantizing the whole loaded tree, which
    are the JAX quantizer's (tests/test_torch_quant.py)."""
    from llm_consensus_tpu.ops.quant import quantize_params as jax_quantize

    path = str(tmp_path / preset)
    _make_hf_checkpoint(jax_config(preset), path, seed=3)
    cfg = get_config(preset)
    streamed = load_hf_safetensors(cfg, path, device=CPU, dtype=torch.float32, quant=mode)
    whole = tq.quantize_params(load_hf_safetensors(cfg, path, device=CPU,
                                                   dtype=torch.float32), mode)
    jax_tree = _flat_jax(jax_quantize(jax_load(jax_config(preset), path, dtype=jnp.float32),
                                      mode=mode))
    got, want = _flat_port(streamed), _flat_port(whole)
    assert set(got) == set(want) == set(jax_tree)
    for key in want:
        assert torch.equal(got[key], want[key]), key
        np.testing.assert_array_equal(got[key].numpy(), jax_tree[key], err_msg=key)
    assert not tq.is_quantized(streamed["layers"].get("w_router", torch.empty(0)))


def test_half_precision_files_load(tmp_path):
    """BF16 and F16 files (the JAX loader reads numpy and has no bfloat16):
    the port loads each to the values of the F32 checkpoint rounded to the
    file's dtype."""
    from safetensors.torch import save_file

    cfg = get_config("tiny-mixtral")
    tensors = _make_hf_checkpoint(jax_config("tiny-mixtral"), str(tmp_path / "f32"), seed=5)
    ref = _flat_port(load_hf_safetensors(cfg, str(tmp_path / "f32"), device=CPU,
                                         dtype=torch.float32))
    for dtype in (torch.bfloat16, torch.float16):
        path = tmp_path / str(dtype)
        path.mkdir()
        save_file({k: torch.from_numpy(v).to(dtype) for k, v in tensors.items()},
                  str(path / "model.safetensors"))
        got = _flat_port(load_hf_safetensors(cfg, str(path), device=CPU, dtype=torch.float32))
        for key, t in ref.items():
            assert torch.equal(got[key], t.to(dtype).float()), (dtype, key)


def test_try_load_params_formats(tmp_path):
    cfg = get_config("tiny-llama")
    assert try_load_params(cfg, None, device=CPU) is None
    assert try_load_params(cfg, str(tmp_path / "missing"), device=CPU) is None
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "README").write_text("no weights here")
    assert try_load_params(cfg, str(tmp_path / "other"), device=CPU) is None
    for marker in ("_METADATA", "manifest.ocdbt"):
        orbax = tmp_path / f"orbax-{marker}"
        orbax.mkdir()
        (orbax / marker).write_text("{}")
        with pytest.raises(ValueError, match="Orbax"):
            try_load_params(cfg, str(orbax), device=CPU)
    _make_hf_checkpoint(jax_config("tiny-llama"), str(tmp_path / "hf"), seed=1)
    params = try_load_params(cfg, str(tmp_path / "hf"), device=CPU, dtype=torch.float32)
    assert params["layers"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                            cfg.n_heads * cfg.head_dim)


def test_provider_builds_from_the_checkpoint_directory(tmp_path):
    """``GPUProvider(checkpoint_dir=...)``: the preset with a directory
    loads it (greedy tokens equal the JAX engine's on the same file, in
    float32), a preset without one random-initializes."""
    from llm_consensus_tpu.engine import Engine as JaxEngine
    from llm_consensus_tpu.engine import SamplingParams as JaxSampling
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    _make_hf_checkpoint(jax_config("tiny-mixtral"), str(tmp_path / "tiny-mixtral"), seed=2)
    provider = GPUProvider(device="cpu", checkpoint_dir=str(tmp_path))
    engine = provider._engine_for("gpu:tiny-mixtral")
    src = SafetensorsDir(str(tmp_path / "tiny-mixtral"))
    assert torch.equal(engine.params["embed"],
                       src.get("model.embed_tokens.weight").to(torch.bfloat16))
    random_engine = provider._engine_for("gpu:tiny-llama")
    assert random_engine.params["layers"]["attn_norm"].eq(1).all()

    cfg = get_config("tiny-mixtral")
    path = str(tmp_path / "tiny-mixtral")
    ours = Engine(cfg, load_hf_safetensors(cfg, path, device=CPU, dtype=torch.float32),
                  dtype=torch.float32, max_seq=128, device="cpu")
    theirs = JaxEngine(jax_config("tiny-mixtral"),
                       params=jax_load(jax_config("tiny-mixtral"), path, dtype=jnp.float32),
                       dtype=jnp.float32, max_seq=128)
    sp = dict(max_new_tokens=24, ignore_eos=True)
    assert (ours.generate("checkpoint probe", SamplingParams(**sp)).token_ids
            == theirs.generate("checkpoint probe", JaxSampling(**sp)).token_ids)
    provider.release()


def test_no_safetensors_package_needed():
    import llm_consensus_tpu_torch.engine.checkpoint as mod

    with open(mod.__file__) as f:
        src = f.read()
    assert "import safetensors" not in src and "from safetensors" not in src


def test_chip_smoke_writer_is_read_by_safe_open_and_the_loader(tmp_path):
    """chip_smoke.py writes its synthetic checkpoints without the
    safetensors package: ``safe_open`` reads them back, and so does the
    port's loader (a whole tiny-qwen2 checkpoint, biases included)."""
    from safetensors import safe_open

    from chip_smoke import synthetic_hf_tensors, write_safetensors

    tensors = {"f32": torch.randn(3, 5), "f16": torch.randn(4).half(),
               "bf16": torch.randn(2, 2, 3).to(torch.bfloat16)}
    write_safetensors(str(tmp_path / "t.safetensors"), tensors)
    with safe_open(str(tmp_path / "t.safetensors"), framework="pt") as f:
        for name, t in tensors.items():
            assert torch.equal(f.get_tensor(name), t), name
    cfg = get_config("tiny-qwen2")
    (tmp_path / cfg.name).mkdir()
    hf = synthetic_hf_tensors(torch, cfg, seed=4)
    write_safetensors(str(tmp_path / cfg.name / "model.safetensors"), hf)
    params = load_hf_safetensors(cfg, str(tmp_path / cfg.name), device=CPU)
    assert torch.equal(params["layers"]["bq"][1], hf["model.layers.1.self_attn.q_proj.bias"])
    assert torch.equal(params["layers"]["w_down"][0],
                       hf["model.layers.0.mlp.down_proj.weight"].t())
