"""Judge distillation over the served corpus on one device (port of
``llm_consensus_tpu/flywheel/distill.py``; its mesh arguments and
``opt_state_shardings`` wait for ``parallel/``).

The student trains on ``alpha * KL(teacher logits) + (1 - alpha) *
CE(verdict tokens)`` (train/loss.py ``distill_loss``) over the examples
flywheel/corpus.py extracts from ``data/`` run directories. The teacher's
forward runs under ``torch.no_grad`` in the same step; each layer of the
student's forward is checkpointed (``remat``). The optimizer is the train
step's (AdamW behind a global-norm clip, train/step.py, where the two
differences from optax are stated).

Checkpoints are **HF safetensors** (engine/checkpoint.py
``save_hf_safetensors``; the JAX package writes Orbax) under a versioned
layout the hot-swap half reads::

    <out_dir>/v<NNNN>/params/model.safetensors
    <out_dir>/v<NNNN>/version.json
        {"version": N, "corpus_hash": ..., "student": ..., "step": ...,
         "params_digest": ...}

``version`` is monotone per ``out_dir`` (:func:`next_version`).
``version.json`` is written last, through a temporary file, fsync and
rename, and :func:`latest_checkpoint` takes only versions that have it, so
a save torn anywhere before that is invisible. (The JAX
``latest_checkpoint`` returns a version whose ``params/`` exists without
its ``version.json``.) ``params_digest`` is ``integrity.digest_tree`` of
the tree as written; ``GPUProvider.swap_weights`` checks it on the tree it
reads back before anything installs.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from llm_consensus_tpu_torch.models.config import ModelConfig, get_config
from llm_consensus_tpu_torch.models.transformer import forward, init_params
from llm_consensus_tpu_torch.train.loss import distill_loss
from llm_consensus_tpu_torch.train.step import (
    OptimizerSpec, TrainState, apply_gradients, default_optimizer, init_train_state)
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_LR = 1e-4


def default_distill_optimizer(lr: float = DEFAULT_LR, weight_decay: float = 0.1,
                              clip_norm: float = 1.0) -> OptimizerSpec:
    """AdamW behind a global-norm clip at the distillation learning rate."""
    return default_optimizer(lr=lr, weight_decay=weight_decay, clip_norm=clip_norm)


def init_distill_state(cfg: ModelConfig, seed: int = 0,
                       optimizer: Optional[OptimizerSpec] = None, *,
                       device: DeviceLike = None, dtype: torch.dtype = torch.bfloat16,
                       params: Optional[dict] = None) -> TrainState:
    """Student parameters (random from ``seed``, or a copy of ``params``)
    and the optimizer over them; bf16 by default, as in JAX."""
    return init_train_state(cfg, seed, optimizer or default_distill_optimizer(),
                            device=device, dtype=dtype, params=params)


def _teacher_logits(teacher_params: dict, teacher_cfg: ModelConfig, tokens: torch.Tensor):
    with torch.no_grad():
        logits, _ = forward(teacher_params, teacher_cfg, tokens)
    return logits


def make_distill_step(cfg: ModelConfig, teacher_cfg: ModelConfig, remat: bool = True,
                      temperature: float = 2.0, alpha: float = 0.5):
    """``step_fn(state, teacher_params, batch) -> (state, metrics)``:
    ``batch`` is ``{"tokens", "targets", "mask"}`` each [B, T]; metrics
    carry ``loss``, ``kl``, ``ce`` and ``grad_norm`` as floats. The state
    is updated in place, with its own optimizer, and returned."""

    def step_fn(state: TrainState, teacher_params: dict, batch: dict):
        teacher = _teacher_logits(teacher_params, teacher_cfg, batch["tokens"])
        state.opt_state.zero_grad(set_to_none=True)
        logits, _ = forward(state.params, cfg, batch["tokens"], remat=remat)
        loss, aux = distill_loss(logits, teacher, batch["targets"], batch.get("mask"),
                                 temperature=temperature, alpha=alpha)
        loss.backward()
        norm = apply_gradients(state)
        return state, {"loss": float(loss.detach()), "kl": float(aux["kl"].detach()),
                       "ce": float(aux["ce"].detach()), "grad_norm": float(norm)}

    return step_fn


def make_distill_eval(cfg: ModelConfig, teacher_cfg: ModelConfig, temperature: float = 2.0,
                      alpha: float = 0.5):
    """``eval_fn(params, teacher_params, batch) -> loss`` (a float) for the
    holdout split: the same objective, no gradient (so nothing to
    recompute: the JAX eval's ``remat`` has no counterpart)."""

    def eval_fn(params: dict, teacher_params: dict, batch: dict) -> float:
        with torch.no_grad():
            teacher = _teacher_logits(teacher_params, teacher_cfg, batch["tokens"])
            logits, _ = forward(params, cfg, batch["tokens"])
            loss, _aux = distill_loss(logits, teacher, batch["targets"], batch.get("mask"),
                                      temperature=temperature, alpha=alpha)
        return float(loss)

    return eval_fn


# -- versioned checkpoints ---------------------------------------------------


def _version_dirs(out_dir: str) -> list[tuple[int, str]]:
    """``[(version, dir)]`` ascending for every ``v<NNNN>/`` in out_dir."""
    try:
        entries = os.listdir(out_dir)
    except OSError:
        return []
    return sorted((int(name[1:]), os.path.join(out_dir, name)) for name in entries
                  if name.startswith("v") and name[1:].isdigit())


def next_version(out_dir: str) -> int:
    """The next monotone weight version for ``out_dir`` (serving starts at
    version 0, so the first distilled checkpoint is 1); a torn save's
    directory counts, so its number is never reused."""
    dirs = _version_dirs(out_dir)
    return (dirs[-1][0] + 1) if dirs else 1


def latest_checkpoint(out_dir: str) -> Optional[dict]:
    """``{"version", "params_path", ...version.json's fields}`` of the
    newest complete checkpoint under ``out_dir`` (its ``version.json``
    written and parsable), or None."""
    for version, vdir in reversed(_version_dirs(out_dir)):
        params_path = os.path.join(vdir, "params")
        if not os.path.isdir(params_path):
            continue
        try:
            with open(os.path.join(vdir, "version.json"), "r", encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue  # torn: version.json is written last
        if not isinstance(meta, dict):
            continue
        meta.setdefault("version", version)
        meta["params_path"] = params_path
        return meta
    return None


def _fsync_dir(path: str) -> None:
    """fsync a directory, so a rename into it is durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(out_dir: str, version: int, params: dict, meta: dict, *,
                    cfg: ModelConfig) -> str:
    """Write ``<out_dir>/v<NNNN>/{params/model.safetensors, version.json}``;
    returns the version directory. The tensors are written and fsynced
    first; ``version.json`` (with ``params_digest`` of the tree as written)
    last, through a temporary file, fsync, rename and a directory fsync."""
    from llm_consensus_tpu_torch import integrity
    from llm_consensus_tpu_torch.engine.checkpoint import save_hf_safetensors

    vdir = os.path.join(out_dir, f"v{version:04d}")
    os.makedirs(vdir, exist_ok=True)
    tree = _detached(params)
    save_hf_safetensors(cfg, tree, os.path.join(vdir, "params"))
    _fsync_dir(os.path.join(vdir, "params"))
    doc = dict(meta)
    doc["version"] = version
    doc["params_digest"] = integrity.digest_tree(tree)
    meta_path = os.path.join(vdir, "version.json")
    tmp_path = meta_path + ".tmp"
    with open(tmp_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_path, meta_path)
    _fsync_dir(vdir)
    return vdir


def _detached(tree: dict) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


# -- the loop ----------------------------------------------------------------


def _batches(encoded: dict, batch: int, steps: int, device: torch.device):
    """Cycle the encoded corpus into ``steps`` [batch, seq] batches
    (examples repeat round-robin when the corpus is smaller)."""
    n = len(encoded["tokens"])
    if n == 0:
        return
    idx = 0
    for _ in range(steps):
        rows = [(idx + i) % n for i in range(batch)]
        idx = (idx + batch) % n
        yield {
            "tokens": torch.tensor([encoded["tokens"][r] for r in rows], dtype=torch.long,
                                   device=device),
            "targets": torch.tensor([encoded["targets"][r] for r in rows], dtype=torch.long,
                                    device=device),
            "mask": torch.tensor([encoded["mask"][r] for r in rows], dtype=torch.float32,
                                 device=device),
        }


def run_distill(corpus, student: str = "tiny-llama", teacher: Optional[str] = None,
                out_dir: Optional[str] = None, *, device: DeviceLike = None,
                checkpoint_dir: Optional[str] = None, steps: int = 20, lr: float = DEFAULT_LR,
                batch: int = 2, seq: int = 128, temperature: float = 2.0, alpha: float = 0.5,
                ckpt_every: int = 0, dtype: torch.dtype = torch.float32, log=None) -> dict:
    """One distillation run over ``corpus``; returns its summary (the JAX
    keys). Student and teacher load from ``checkpoint_dir/<preset>/`` (HF
    safetensors) when present, else random-init from seeds 0 and 1 on the
    device; the holdout loss is evaluated before and after; one versioned
    checkpoint is saved at the end (and every ``ckpt_every`` steps before
    it), tagged with the corpus hash. ``device=None`` is the current CUDA
    card (raises without one). The settings' defaults are the
    ``LLMC_DISTILL_*`` knobs'."""
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer
    from llm_consensus_tpu_torch.flywheel.corpus import encode_examples
    from llm_consensus_tpu_torch.obs import attrib

    dev = resolve_device(device)
    teacher = teacher or student
    log = log or (lambda _msg: None)
    cfg, teacher_cfg = get_config(student), get_config(teacher)
    tokenizer = student_params = teacher_params = None
    if checkpoint_dir:
        student_params = try_load_params(cfg, os.path.join(checkpoint_dir, student),
                                         device=dev, dtype=dtype)
        teacher_params = try_load_params(teacher_cfg, os.path.join(checkpoint_dir, teacher),
                                         device=dev, dtype=dtype)
        tokenizer = load_tokenizer(os.path.join(checkpoint_dir, student))
    if tokenizer is None:
        tokenizer = ByteTokenizer()

    encoded = encode_examples(tokenizer, corpus.train, seq)
    holdout = encode_examples(tokenizer, corpus.holdout or corpus.train, seq)
    summary = dict(corpus.summary())
    summary.update({"student": student, "teacher": teacher, "steps": 0, "batch": batch,
                    "seq": seq})
    if not encoded["tokens"]:
        summary["error"] = "empty corpus"
        return summary
    if teacher_params is None:
        teacher_params = init_params(teacher_cfg, 1, device=dev, dtype=dtype)

    optimizer = default_distill_optimizer(lr)
    state = init_distill_state(cfg, 0, optimizer, device=dev, dtype=dtype,
                               params=student_params)
    student_params = None  # the state holds its own copy
    step_fn = make_distill_step(cfg, teacher_cfg, temperature=temperature, alpha=alpha)
    eval_fn = make_distill_eval(cfg, teacher_cfg, temperature=temperature, alpha=alpha)

    def holdout_loss(params) -> float:
        n = max(1, (len(holdout["tokens"]) + batch - 1) // batch)
        losses = [eval_fn(params, teacher_params, b) for b in _batches(holdout, batch, n, dev)]
        return sum(losses) / max(len(losses), 1)

    summary["holdout_loss_before"] = holdout_loss(state.params)
    version = next_version(out_dir) if out_dir else 0
    last: dict = {}
    done = 0
    for i, b in enumerate(_batches(encoded, batch, steps, dev)):
        with attrib.tag("train_step"):
            state, last = step_fn(state, teacher_params, b)
        done = i + 1
        log(f"distill step {done}/{steps}: loss={last['loss']:.4f} kl={last['kl']:.4f} "
            f"ce={last['ce']:.4f}")
        if out_dir and ckpt_every and done % ckpt_every == 0 and done < steps:
            save_checkpoint(out_dir, version, state.params, {
                "corpus_hash": corpus.corpus_hash, "student": student, "teacher": teacher,
                "step": done, **last}, cfg=cfg)
            version += 1
    summary["steps"] = done
    summary.update(last)
    summary["holdout_loss_after"] = holdout_loss(state.params)
    if out_dir:
        vdir = save_checkpoint(out_dir, version, state.params, {
            "corpus_hash": corpus.corpus_hash, "student": student, "teacher": teacher,
            "step": done, "holdout_loss_before": summary["holdout_loss_before"],
            "holdout_loss_after": summary["holdout_loss_after"], **last}, cfg=cfg)
        summary["weight_version"] = version
        summary["checkpoint"] = vdir
    return summary


__all__ = [
    "default_distill_optimizer", "init_distill_state", "latest_checkpoint",
    "make_distill_eval", "make_distill_step", "next_version", "run_distill",
    "save_checkpoint",
]
