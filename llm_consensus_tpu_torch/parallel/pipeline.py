"""GPipe pipeline parallelism over a ``pp`` axis (port of
``llm_consensus_tpu/parallel/pipeline.py``).

Stage ``s`` holds layers ``[s L/S, (s+1) L/S)`` of the layer-stacked tree on
its position's device (the same tree serves tensor and pipeline
parallelism); activations hop stage to stage by copy (``.to(device)``), and
gradients flow back through autograd across those copies (the backward of
a copy is the reverse copy), as JAX's ``ppermute`` transposes.

Schedule: classic GPipe over ``M`` microbatches, ``M + S - 1`` clock
ticks, stage ``s`` running microbatch ``t - s`` at tick ``t``. The host
issues the ticks in order (within a tick, the later stages first, so each
consumes what its predecessor produced the tick before); on separate cards
the stages' kernels then run concurrently. JAX's v2 layout is kept:
microbatch ``g`` waits on stage ``g % S`` and its output lands there, so
each stage holds ``M / S`` of the batch at each end.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_consensus_tpu_torch.ops.attention import make_attention_mask
from llm_consensus_tpu_torch.ops.quant import qmatmul
from llm_consensus_tpu_torch.ops.rope import rope_angles, rope_inv_freq
from llm_consensus_tpu_torch.parallel.mesh import Mesh


def _stage_layers(params: dict, lo: int, hi: int, dev: torch.device) -> list:
    """Layer views of ``[lo, hi)`` on ``dev`` (differentiable copies)."""
    from llm_consensus_tpu_torch.models.transformer import layer_views

    return layer_views({"layers": {k: v[lo:hi].to(dev) for k, v in params["layers"].items()}})


def pipeline_forward(params: dict, cfg, tokens: torch.Tensor, mesh: Mesh,
                     axis_name: str = "pp", microbatches: Optional[int] = None) -> torch.Tensor:
    """Training/eval forward with the layers pipelined over ``axis_name``.

    Returns logits [B, T, V] fp32 on ``tokens``' device, equal to
    ``forward(params, cfg, tokens)`` (same layer math, same order).
    Constraints, the JAX ones: layers divisible by the stage count, batch by
    the microbatch count, microbatches by the stage count. Default
    microbatches: the smallest multiple of the stage count >= 4."""
    from llm_consensus_tpu_torch.models.transformer import _layer, embed_tokens, unembed

    n_stages = mesh.shape[axis_name]
    if microbatches is None:
        microbatches = n_stages * max(1, -(-4 // n_stages))
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by {n_stages} stages")
    b, t = tokens.shape
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} microbatches")
    if microbatches % n_stages:
        raise ValueError(
            f"{microbatches} microbatches not divisible by {n_stages} stages "
            "(the v2 schedule keeps M/S microbatches resident per stage)")
    mb = b // microbatches
    per = cfg.n_layers // n_stages
    devs = [mesh.devices.flat[mesh.flat_index(**{axis_name: s})].torch_device
            for s in range(n_stages)]
    home = tokens.device

    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(t, dtype=torch.int32, device=home)[None, :].expand(mb, t)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_dict, device=home)
    cos, sin = rope_angles(positions, inv_freq)
    mask = make_attention_mask(positions, positions, None, cfg.sliding_window)
    per_dev = [(cos.to(d), sin.to(d), mask.to(d)) for d in devs]
    stages = [_stage_layers(params, s * per, (s + 1) * per, devs[s]) for s in range(n_stages)]

    def run_stage(s: int, h: torch.Tensor) -> torch.Tensor:
        c, sn, m = per_dev[s]
        for j, lp in enumerate(stages[s]):
            h = _layer(cfg, h, lp, c, sn, m, None, 0, s * per + j, None, None, None, None,
                       None, False, qmatmul, False, None, None, None)
        return h

    # Stage-resident queues: microbatch g waits on (and returns to) stage g % S.
    feeds = [x[g * mb:(g + 1) * mb].to(devs[g % n_stages]) for g in range(microbatches)]
    outs: list = [None] * microbatches
    recv: list = [None] * n_stages  # what each stage received at the last tick
    for tick in range(microbatches + n_stages - 1):
        for s in reversed(range(n_stages)):
            g = tick - s
            if not 0 <= g < microbatches:
                continue
            inp = feeds[g].to(devs[0]) if s == 0 else recv[s]
            y = run_stage(s, inp)
            if s == n_stages - 1:
                outs[g] = y.to(devs[g % n_stages])
            else:
                recv[s + 1] = y.to(devs[s + 1])
    ys = torch.cat([o.to(home) for o in outs], dim=0)
    return unembed(params, cfg, ys)


def dryrun_pipeline(n_devices: int, devices=None) -> None:
    """One pipelined AdamW train step of ``tiny-llama`` at 8 layers on small
    shapes over up to ``n_devices`` positions (``devices``, else
    ``virtual_devices(n_devices)`` on the card); prints one line."""
    from llm_consensus_tpu_torch.models.config import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from llm_consensus_tpu_torch.train.loss import cross_entropy_loss

    devices = list(devices if devices is not None else virtual_devices(n_devices))[:n_devices]
    cfg = get_config("tiny-llama", n_layers=8)
    pp = 1
    while pp * 2 <= min(n_devices, cfg.n_layers) and cfg.n_layers % (pp * 2) == 0:
        pp *= 2
    mesh = make_mesh({"pp": pp}, devices[:pp])
    microbatches = max(4, pp)
    dev = devices[0].torch_device
    params = init_params(cfg, 0, device=dev, dtype=torch.float32)
    leaves = []

    def trainable(tree):
        out = {}
        for k, v in tree.items():
            out[k] = trainable(v) if isinstance(v, dict) else v.requires_grad_(True)
            if not isinstance(v, dict):
                leaves.append(out[k])
        return out

    params = trainable(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    opt = torch.optim.AdamW(leaves, lr=1e-3, weight_decay=1e-4)
    loss = cross_entropy_loss(pipeline_forward(params, cfg, tokens, mesh,
                                               microbatches=microbatches), targets)
    loss.backward()
    opt.step()
    value = float(loss.detach())
    if not torch.isfinite(torch.tensor(value)):
        raise AssertionError("pipeline: non-finite loss")
    print(f"[dryrun] pipeline pp={pp} microbatches={microbatches} loss={value:.4f} ok")


__all__ = ["dryrun_pipeline", "pipeline_forward"]
