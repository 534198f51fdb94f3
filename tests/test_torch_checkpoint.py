"""The port's HF safetensors loader (engine/checkpoint.py) against the JAX
package's and against the ``safetensors`` package.

Synthetic HF-layout checkpoints are written as ``tests/test_hf_golden.py``
writes them (seeded random, real safetensors files). The port's reader must
give exactly what ``safe_open`` gives for F32, F16 and BF16 tensors, and the
port's loaded tree must equal the JAX loader's leaf for leaf, exactly (the
same bytes converted to the same dtype): float32 and bfloat16, for the
llama, qwen2 (biases), gemma (norm offset, tied head) and mixtral (stacked
experts) layouts. Quantized loads equal quantizing the loaded tree. A
checkpoint restored onto a mesh of several positions reads each position's
blocks straight into its shard: each shard equals the whole import cut by
``shard_pytree`` and the JAX sharded import's block on the same device.
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


# -- checkpoints restored straight into their shards --------------------------------
#
# The port's counterparts of tests/test_checkpoint.py's sharded cases, over
# eight CPU positions: each position's shard must equal, leaf for leaf and
# bit for bit, the one the whole-tree import then ``shard_pytree`` gives, and
# the block the JAX sharded import places on the same device.


def _tp_configs(family="llama"):
    """tests/test_checkpoint.py's tp-friendly config (every dim divisible
    by tp 8), in both packages, for the llama, qwen2 (biases) and mixtral
    (experts) layouts."""
    from llm_consensus_tpu.models.config import ModelConfig as JaxModelConfig
    from llm_consensus_tpu_torch.models.config import ModelConfig

    extra = {"llama": {}, "qwen2": {"qkv_bias": True},
             "mixtral": {"n_experts": 8, "experts_per_token": 2}}[family]
    kw = dict(name=f"tp-{family}", family=family, vocab_size=512, d_model=64, n_layers=2,
              n_heads=8, n_kv_heads=8, head_dim=8, d_ff=256, max_seq_len=256, **extra)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _port_mesh(axes=None):
    from llm_consensus_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    return make_mesh(axes or {"dp": 1, "tp": 8}, virtual_devices(8, "cpu"))


def _jax_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]).reshape(8), ("tp",))


def _whole_then_shard(cfg, path, mesh, quant=None):
    from llm_consensus_tpu_torch.parallel.sharding import param_specs, shard_pytree

    tree = load_hf_safetensors(cfg, path, device=CPU, dtype=torch.float32)
    if quant:
        tree = tq.quantize_params(tree, quant)
    return shard_pytree(tree, param_specs(cfg, mesh), mesh)


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for p, (a, b) in enumerate(zip(got, want)):
        fa, fb = _flat_port(a), _flat_port(b)
        assert set(fa) == set(fb), p
        for key, t in fb.items():
            assert fa[key].dtype == t.dtype and fa[key].shape == t.shape, (p, key)
            assert torch.equal(fa[key], t), (p, key)


def _assert_tp_sharded(shards, cfg, mesh):
    """Sharded leaves carry 1/tp of their elements per position, the
    others all of theirs, and the big leaves all shard
    (tests/test_checkpoint.py's rule)."""
    from llm_consensus_tpu_torch.parallel.sharding import param_shapes, param_specs

    tp = mesh.shape["tp"]
    shapes = dict(_spec_leaves(param_shapes(cfg)))
    total = sharded = 0
    for shard in (s for s in shards if s is not None):
        for name, spec in _spec_leaves(param_specs(cfg, mesh)):
            whole = int(np.prod(shapes[name]))
            split = any(ax is not None for ax in spec)
            assert dict(param_leaves(shard))[name].numel() == (whole // tp if split else whole)
            total += whole
            sharded += whole if split else 0
    assert sharded / total > 0.75


def _spec_leaves(tree, prefix=""):
    """(dotted name, leaf) of a spec or shape tree (its leaves are tuples)."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _spec_leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def _assert_equals_jax_blocks(shards, jax_tree, mesh):
    """Each position's shard holds the block the JAX sharded import placed
    on the JAX device of the same flat index."""
    jdevs = jax.devices()[:mesh.size]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    for p, shard in enumerate(shards):
        ours = _flat_port(shard)
        assert set(ours) == set(flat)
        for key, leaf in flat.items():
            (block,) = [s.data for s in leaf.addressable_shards if s.device == jdevs[p]]
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(block),
                                          err_msg=f"{p} {key}")


def test_hf_sharded_restore_matches_full_import(tmp_path):
    from llm_consensus_tpu.engine.checkpoint import load_hf_safetensors_sharded as jax_sharded
    from llm_consensus_tpu_torch.engine.checkpoint import load_hf_safetensors_sharded

    jcfg, cfg = _tp_configs()
    path = str(tmp_path / "hf")
    _make_hf_checkpoint(jcfg, path, seed=11)
    mesh = _port_mesh()
    shards = load_hf_safetensors_sharded(cfg, path, mesh, dtype=torch.float32)
    _assert_shards_equal(shards, _whole_then_shard(cfg, path, mesh))
    _assert_tp_sharded(shards, cfg, mesh)
    _assert_equals_jax_blocks(shards, jax_sharded(jcfg, path, _jax_mesh(), dtype=jnp.float32),
                              mesh)


def test_try_load_routes_to_sharded_on_mesh(tmp_path, monkeypatch):
    """``try_load_params(mesh=)`` with several positions restores the shards
    directly (the whole-tree loader never runs), in the engine's form: a
    dp axis's positions past its first index hold none; the engine takes
    them as they are and generates what it generates from the whole tree."""
    import llm_consensus_tpu_torch.engine.checkpoint as ck
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams

    jcfg, cfg = _tp_configs()
    path = str(tmp_path / "hf")
    _make_hf_checkpoint(jcfg, path, seed=12)
    whole = load_hf_safetensors(cfg, path, device=CPU, dtype=torch.float32)
    mesh = _port_mesh()

    def no_whole(*a, **k):
        raise AssertionError("the sharded route must not import the whole tree")

    monkeypatch.setattr(ck, "load_hf_safetensors", no_whole)
    shards = try_load_params(cfg, path, mesh=mesh, dtype=torch.float32)
    _assert_tp_sharded(shards, cfg, mesh)
    dp_mesh = _port_mesh({"dp": 2, "tp": 4})
    dp_shards = try_load_params(cfg, path, mesh=dp_mesh, dtype=torch.float32)
    assert [s is None for s in dp_shards] == [dp_mesh.coords(i)["dp"] == 1 for i in range(8)]
    monkeypatch.undo()
    sp = SamplingParams(max_new_tokens=12, ignore_eos=True)
    want = Engine(cfg, whole, dtype=torch.float32, max_seq=128, mesh=mesh).generate("probe", sp)
    got = Engine(cfg, shards, dtype=torch.float32, max_seq=128, mesh=mesh).generate("probe", sp)
    assert got.token_ids == want.token_ids
    with pytest.raises(ValueError, match="as many positions"):
        Engine(cfg, shards[:4], dtype=torch.float32, max_seq=128, mesh=mesh)


@pytest.mark.parametrize("family", ["qwen2", "mixtral"])
def test_hf_sharded_restore_moe_and_bias(tmp_path, family):
    """The sliced importer covers the qwen2 bias and the mixtral experts'
    layouts (experts split over tp when the mesh has no ep axis)."""
    from llm_consensus_tpu.engine.checkpoint import load_hf_safetensors_sharded as jax_sharded
    from llm_consensus_tpu_torch.engine.checkpoint import load_hf_safetensors_sharded

    jcfg, cfg = _tp_configs(family)
    path = str(tmp_path / family)
    _make_hf_checkpoint(jcfg, path, seed=13)
    mesh = _port_mesh()
    shards = load_hf_safetensors_sharded(cfg, path, mesh, dtype=torch.float32)
    _assert_shards_equal(shards, _whole_then_shard(cfg, path, mesh))
    _assert_equals_jax_blocks(shards, jax_sharded(jcfg, path, _jax_mesh(), dtype=jnp.float32),
                              mesh)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("preset,axes", [
    ("tiny-llama", {"dp": 1, "tp": 2}),
    ("tiny-mixtral", {"dp": 1, "ep": 2, "tp": 2}),
])
def test_quantized_sharded_restore_equals_quantizing_the_whole_tree(tmp_path, preset, axes,
                                                                    mode):
    """With ``quant`` each block quantizes as it lands, to the whole leaf's
    codes and scales: a row-split int8 weight (wo, w_down) takes its column
    scales from every position's rows."""
    from llm_consensus_tpu_torch.engine.checkpoint import load_hf_safetensors_sharded
    from llm_consensus_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    over = {"head_dim": 64}  # the int4 row blocks of wo hold whole 128-row groups
    jcfg, cfg = jax_config(preset, **over), get_config(preset, **over)
    path = str(tmp_path / preset)
    _make_hf_checkpoint(jcfg, path, seed=14)
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, virtual_devices(n, "cpu"))
    shards = load_hf_safetensors_sharded(cfg, path, mesh, dtype=torch.float32, quant=mode)
    _assert_shards_equal(shards, _whole_then_shard(cfg, path, mesh, quant=mode))
    if mode == "int8":
        wo = [s["layers"]["wo"] for s in shards]
        assert torch.equal(wo[0]["s"], wo[1]["s"])  # one scale set over both row blocks
    # At the preset's own head width wo's rows split into blocks of 64, under
    # one int4 group: refused, as shard_pytree refuses the whole tree's.
    small = str(tmp_path / f"{preset}-dh32")
    _make_hf_checkpoint(jax_config(preset), small, seed=15)
    with pytest.raises(ValueError, match="int4 groups"):
        load_hf_safetensors_sharded(get_config(preset), small, mesh, quant="int4")


def test_provider_restores_a_placed_model_into_its_shards(tmp_path, monkeypatch):
    """``GPUProvider(checkpoint_dir=)`` building a model placed on several
    positions passes its mesh to the loader: the engine's shards are the
    sharded import's, and no whole tree is loaded or moved."""
    import llm_consensus_tpu_torch.engine.checkpoint as ck
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    _make_hf_checkpoint(jax_config("tiny-llama"), str(tmp_path / "tiny-llama"), seed=16)
    cfg = get_config("tiny-llama")
    from llm_consensus_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    mesh = make_mesh({"dp": 1, "tp": 2}, virtual_devices(2, "cpu"))
    want = ck.load_hf_safetensors_sharded(cfg, str(tmp_path / "tiny-llama"), mesh)

    def no_whole(*a, **k):
        raise AssertionError("a placed model must not import the whole tree")

    monkeypatch.setattr(ck, "load_hf_safetensors", no_whole)
    provider = GPUProvider(device="cpu", checkpoint_dir=str(tmp_path))
    provider._meshes["tiny-llama"] = mesh
    engine = provider._engine_for("gpu:tiny-llama")
    assert engine.sharded and engine.params is None
    _assert_shards_equal(engine._shards, want)
    provider.release()


def test_range_reads_equal_slices_of_the_whole_tensor(tmp_path):
    """``SafetensorsDir.get_slice`` reads a block's byte ranges: the block of
    every dtype, at leading-dim blocks of every depth, equals the slice of
    the whole tensor."""
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(1)
    tensors = {f"t.{dt}": torch.randn(6, 5, 4, generator=gen).to(dt)
               for dt in (torch.float32, torch.float16, torch.bfloat16)}
    save_file(tensors, str(tmp_path / "model.safetensors"))
    src = SafetensorsDir(str(tmp_path))
    for name, t in tensors.items():
        for index in [(), (slice(2, 5),), (slice(0, 6), slice(1, 3)),
                      (slice(1, 4), slice(0, 5), slice(2, 4)), (slice(3, 3),),
                      (slice(0, 6), slice(0, 5), slice(0, 4))]:
            got = src.get_slice(name, index)
            assert got.dtype == t.dtype and torch.equal(got, t[index]), (name, index)
    with pytest.raises(ValueError, match="block"):
        src.get_slice("t.torch.float32", (slice(0, 6, 2),))
