"""The ``gpu`` provider: on-device inference behind the Provider seam
(port of the single-stream half of ``llm_consensus_tpu/providers/tpu.py``).

Model names are ``gpu:<preset>`` for any preset of the catalog
(models/config.py), mixture-of-experts presets included, e.g.
``gpu:llama-3-8b``, ``gpu:mixtral-8x7b``, ``gpu:consensus-1b``,
``gpu:tiny-llama``. Engines are built lazily, once per preset, and shared
between panel and judge uses; distinct presets build concurrently under
per-preset locks. With ``checkpoint_dir`` each engine loads its weights
and tokenizer from ``<checkpoint_dir>/<preset>/`` (HF safetensors,
engine/checkpoint.py) when that directory exists; otherwise, and without
``checkpoint_dir``, weights are random, made on the device from a seed.
The generation default mirrors the JAX provider's 4096-token cap.

``GPUProvider(device=None)`` runs on the current CUDA card and raises when
there is none; ``device="cpu"`` runs the same path on the CPU. The
quantization modes (``quant``, ``kv_quant``, ``w8a8``, ``decode_w8a8``,
``int4_impl``) go to every engine the provider builds; unknown modes raise
in the constructor, before anything is built.

``max_seq`` caps every engine's context (the draft engine's too) and
``prefill_chunk`` sets every engine's chunked-prefill length (0: one-shot).
``prefix_cache`` and ``prefix_cache_max_mb`` go to every engine (prefix
snapshot reuse, on by default as in the JAX package); ``release()`` drops
the engines with their snapshots and open prefill sessions. ``kv_pool``,
``kv_pool_block`` and ``kv_pool_mb`` go to every engine the provider builds
(the cross-request paged KV pool in place of the snapshot, kv/), the one
``_recover_batcher`` rebuilds included, which starts with a fresh, empty
pool. ``kv_stats()`` reports each pool (the JAX keys) and
``kv_evict_cold(target_occupancy)`` evicts cold blocks from all of them; a
response whose publish the pool truncated carries ``kv={"truncated":
True}``.

``batch_streams`` > 1 routes every request for a preset through one
``ContinuousBatcher`` over that preset's engine (built once, under a build
lock), so concurrent streams of one model share the decode; greedy results
equal the single-stream path's. ``pool_prefix`` and ``pool_prefix_min``
(shared-prefix serving: a panel of one model fans one prompt out to N
streams), ``prefill_budget`` (interleaved admission), ``pool_bucket``
(occupancy row-bucketing) and ``preempt`` (priority preemption) go to the
batcher, and each request's ``priority`` (None: NORMAL) to its submit. A
submit the batcher refuses (``RuntimeError`` or
``ValueError``: it is closed) or a submission a concurrent close cancelled
goes to the single-stream ``engine.generate``.

The retry ladder (the JAX provider's): a failed engine build gets one more
build; a failed generate on which nothing streamed yet evicts the engine,
drops the last reference to it, builds a fresh one and retries once (the
rebuild runs outside the ``except`` block, so the failed engine is
collectible before the new one allocates). On one card there is nowhere
else to place the model, so a second failure fails it (a warning in the
run, as the runner's best-effort rule says). ``torch.cuda.OutOfMemoryError``
is the transient the ladder is for. No step catches ``Cancelled``,
``DeadlineExceeded`` or a ``ValueError`` of the request, nor a
``KernelBuildError`` or ``KernelLaunchError``: a retry on the same kernel
would only hide the fault, so those propagate.

Crash recovery (recovery/): with a ``journal`` (a ``StreamJournal``) every
batched generate runs through an ``EngineSupervisor``: a pool that dies
mid-decode (a crash escaping its scheduler, or a wedge the watchdog sees
when ``engine_heartbeat_s`` > 0) becomes one rebuild of the preset's engine
and batcher (:meth:`GPUProvider._recover_batcher`, serialized per preset)
and a replay of each journaled stream, at most ``engine_restarts`` times a
stream. ``recovery_stats()`` reports the pools' heartbeats and, with
supervision, its restarts, replays and journal depth. The ``build`` fault
site (``build_fail@preset=``) fires in every engine build, which the retry
ladder then handles. ``stream_interval`` and ``ignore_eos`` (the JAX
provider's) go to every engine and request.

Speculative decoding (engine/speculative.py): ``draft`` maps targets to
drafters in the JAX provider's syntax (:func:`_parse_draft_spec`: a preset
drafting for every target, ``target=draft`` pairs, or ``lookup``, the
prompt-lookup drafter); ``spec_k``, ``spec_ngram``, ``spec_adapt``,
``spec_governor`` and ``spec_probe`` are the control plane's settings.
Greedy and pure-temperature requests of a drafted target run through a
``SpeculativeEngine`` (the draft engine is built with the target's
``max_seq`` cap); with batching on only ``lookup`` batches (the pool's
speculative rounds), and a model draft is ignored with one warning. A
configuration error (an unknown draft preset, a draft of another
vocabulary) turns speculation off for that target with one warning and the
plain path serves; a kernel or CUDA error in a draft or verify propagates.
``set_draft`` and ``set_spec_k`` reconfigure (the CLI's ``--draft`` and
``--spec-k``), ``spec_stats()`` reports each preset (the JAX keys).

The serving surface (the JAX provider's, for the ``serve`` gateway and its
pressure governor): ``pressure_stats()`` (each pool's live/cap/queued
headroom), ``utilization_stats()`` (each pool's live decode rate, MFU and
MBU between window advances of at least a second), ``request_preempt`` and
``set_brownout`` (the governor's preempt and brownout rungs; brownout also
routes a drafted single-stream request plain), ``kv_evict_cold`` (the evict
rung), and the weight hot-swap: ``swap_weights(model, params_or_path,
version=None, wait=, meta=)`` loads a path with the port's HF safetensors
reader (``engine/checkpoint.py``; the JAX provider restores an Orbax tree
there), verifies a ``meta["params_digest"]`` against
``integrity.digest_tree`` when the integrity plane is on (a mismatch, or the
``bit_flip@surface=ckpt`` fault, is refused as ``params_digest_mismatch``
before anything installs), and hands the tree to the engine's double
buffer; ``rollback_weights``, ``swap_stats`` and ``weight_version`` report
and undo it. ``swap_wait_s`` (``LLMC_SWAP_WAIT_S``) goes to every engine.

Live stream migration (serve/elastic.py, the JAX provider's): each request's
``trace_id`` goes to its batcher's journal entry, ``seal_stream(trace_id)``
seals that entry and returns its resume payload, and a request's ``resume``
payload replays through the batcher (see :meth:`GPUProvider._generate`).

Disaggregated prefill → decode (engine/handoff.py, the JAX provider's
``disagg``): with ``disagg`` (and a batched provider whose engines run the
KV pool, the handoff channel) each preset's batched requests hand their
prompt to a :class:`~llm_consensus_tpu_torch.engine.handoff.KVHandoff`
first: its prefill worker prefills the prompt and publishes its
whole-block KV into the decode engine's pool, and the batcher's admission
then gathers it and prefills only the tail. Both roles share the
provider's one device (the one-device case of ``parallel/mesh.py``
``split_roles``) and the worker runs on its own CUDA stream; a prompt under
one prefill chunk takes the classic path (``KVHandoff.min_tokens``). On a
provider of several devices ``prepare`` splits each preset's slice into a
prefill and a decode role (``disagg_fraction`` of it to prefill,
``split_roles``), each on its planned mesh (sharded over it when it has
several positions; the handoff reshards each row's KV by heads between the
two), and ``replan_disagg`` re-carves a preset's prefill share at run
time. The prefill engine shares the decode engine's weight tree when both
roles are one unsharded engine's device (no second copy) and keeps a copy
in its own layout otherwise, with its own wave cache, no KV pool and no
prefix snapshot. ``disagg_depth``, ``disagg_wave`` and ``disagg_wait_s`` bound the
handoff queue, a wave and a submitter's wait; ``disagg_overlap`` polls the
wait so a cancelled request abandons it. Any handoff failure (a full
queue, a stall past the wait, a crashed wave) takes the classic path,
which runs the same kernels. ``disagg_stats()`` is the /statsz ``disagg``
block, ``pressure_stats`` folds the handoff queue
into ``queued`` (``handoff_queued``), and ``utilization_stats`` adds a
``<preset>:prefill`` gauge per role.

Placement (parallel/mesh.py, the JAX provider's): the provider's devices
are ``devices`` (mesh positions) or one handle for its ``device``.
``prepare(models, judge, devices=None)`` runs ``plan_panel`` over them
(every process's, under a multi-controller run) and keeps a mesh per
preset: panel models on disjoint slices, the judge on the larger one, each
with its ``best_tp``. An engine is built on its preset's mesh (sharded over
it when the mesh has more than one position); a layout change rebuilds it,
a preset absent from the new plan is evicted, the same layout keeps the
cached engine. ``placement(model)`` is the mesh (parallel/multicontroller.py
reads its owner from it). The retry ladder's third step re-places a model
whose engine failed twice onto healthy positions (``_replace_engine``) and
remembers the failed ones for later plans. One device plans what a single
card always ran: every preset on it.

Telemetry (obs/), bound at construction: an ``engine_stream`` span per
request (recorder and flight recorder, with the request's ``trace``), the
per-token latency into the live plane labeled by the request's priority
class and outcome, and the run-aggregate decode counters
(``decode_tokens``, ``decode_s``, the MFU weights) the CLI's footer and
``metrics.json`` read.
"""

from __future__ import annotations

import gc
import os
import threading
import time
import warnings
from concurrent.futures import CancelledError
from typing import Optional

import torch

from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.engine.engine import PREFIX_CACHE_MAX_MB
from llm_consensus_tpu_torch.obs.live import class_label
from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError
from llm_consensus_tpu_torch.pressure.priority import PRIORITY_NORMAL
from llm_consensus_tpu_torch.providers.base import Provider, Request, Response, StreamCallback
from llm_consensus_tpu_torch.recovery import (
    DEFAULT_HEARTBEAT_S, DEFAULT_MAX_RESTARTS, EngineSupervisor, StreamJournal)
from llm_consensus_tpu_torch.utils.context import Cancelled, Context, DeadlineExceeded
from llm_consensus_tpu_torch.utils.device import DeviceLike, device_name, resolve_device

DEFAULT_MAX_NEW_TOKENS = 4096
SCHEME = "gpu:"
# Errors the retry ladder never retries: a cancel or deadline, the
# request's own ValueError, and a kernel that failed to build or launch.
_NO_RETRY = (Cancelled, DeadlineExceeded, ValueError, KernelBuildError, KernelLaunchError)


def _parse_draft_spec(spec: str) -> dict:
    """``--draft`` / ``LLMC_DRAFT`` → {target preset: draft}: a bare name
    drafts for every target (key ``"*"``), ``a=b`` pairs name one target
    each; the draft ``lookup`` is the prompt-lookup drafter. Drafts are
    checked when a request needs one, not here."""
    out: dict = {}
    for part in (spec or "").strip().split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, draft = part.partition("=")
            out[target.strip()] = draft.strip()
        else:
            out["*"] = part
    return out


def _cast_tree(tree: dict, dtype) -> dict:
    """Every floating leaf of a dense parameter tree in ``dtype``."""
    return {k: _cast_tree(v, dtype) if isinstance(v, dict)
            else (v.to(dtype) if v.is_floating_point() else v) for k, v in tree.items()}


def _mesh_key(mesh):
    """A mesh's layout (device ids, axes, shape), or None."""
    if mesh is None:
        return None
    return (tuple(d.id for d in mesh.devices.flat), tuple(mesh.axis_names),
            tuple(mesh.devices.shape))


def _fits(engine, mesh) -> bool:
    """True when ``engine`` runs on ``mesh``: built on it, or an engine
    placed on a device (no mesh) and a one-position mesh of that device."""
    em = getattr(engine, "mesh", None)
    if em is not None:
        return em is mesh or _mesh_key(em) == _mesh_key(mesh)
    return mesh.size == 1 and mesh.devices.flat[0].torch_device == engine.device


def _mesh_ids(engine) -> set:
    mesh = getattr(engine, "mesh", None)
    return set() if mesh is None else {d.id for d in mesh.devices.flat}


def _to_device(tree, device):
    """A parameter tree on ``device`` (the tree itself when already there)."""
    if tree is None:
        return None
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def parse_model_name(model: str) -> str:
    """``gpu:<preset>`` → preset name; validates against the catalog."""
    from llm_consensus_tpu_torch.models.config import MODEL_PRESETS

    name = model[len(SCHEME):] if model.startswith(SCHEME) else model
    if name not in MODEL_PRESETS:
        available = [f"{SCHEME}{m}" for m in sorted(MODEL_PRESETS)]
        raise ValueError(f"unknown gpu model {model!r}; available: {available}")
    return name


def _resolve_modes(*, quant: Optional[str] = None, kv_quant: Optional[str] = None,
                   w8a8: bool = False, decode_w8a8: bool = False,
                   int4_impl: Optional[str] = None) -> dict:
    """The quantization modes as every engine takes them; an unknown mode
    raises ``ValueError`` here, before anything is built."""
    from llm_consensus_tpu_torch.ops.quant import (
        KV_MODES, WEIGHT_MODES, resolve_int4_impl, resolve_mode)

    return {
        "quant": resolve_mode(quant, "quant", WEIGHT_MODES),
        "kv_quant": resolve_mode(kv_quant, "kv_quant", KV_MODES),
        "w8a8": bool(w8a8), "decode_w8a8": bool(decode_w8a8),
        "int4_impl": resolve_int4_impl(int4_impl),
    }


class GPUProvider(Provider):
    """Serves every ``gpu:*`` model from a lazily built engine pool."""

    name = "gpu"
    _shared: dict = {}  # (device, modes, batching, checkpoints) → provider (see shared())
    _shared_lock = sanitizer.make_lock("providers.gpu.shared")

    def __init__(self, *, device: DeviceLike = None, max_seq: Optional[int] = None,
                 batch_streams: int = 1, pool_prefix: bool = True, pool_prefix_min: int = 192,
                 prefill_budget: int = 0, pool_bucket: bool = True, preempt: bool = True,
                 checkpoint_dir: Optional[str] = None, prefix_cache: bool = True,
                 prefix_cache_max_mb: float = PREFIX_CACHE_MAX_MB,
                 kv_pool: bool = False, kv_pool_block: int = 64, kv_pool_mb: float = 256.0,
                 journal: Optional[StreamJournal] = None,
                 engine_heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 engine_restarts: int = DEFAULT_MAX_RESTARTS,
                 stream_interval: int = 16, ignore_eos: bool = False, draft: str = "",
                 spec_k: int = 4, spec_ngram: int = 3, spec_adapt: bool = True,
                 spec_governor: bool = True, spec_probe: int = 64, swap_wait_s: float = 30.0,
                 prefill_chunk: int = 512, disagg: bool = False,
                 disagg_depth: int = 8, disagg_wave: int = 4, disagg_wait_s: float = 30.0,
                 disagg_overlap: bool = True, disagg_fraction: float = 0.5,
                 devices=None, multihost_placement: bool = True, **modes):
        self.modes = _resolve_modes(**modes)
        self.prefix = {"prefix_cache": bool(prefix_cache),
                       "prefix_cache_max_mb": float(prefix_cache_max_mb)}
        self.kv = {"kv_pool": bool(kv_pool), "kv_pool_block": int(kv_pool_block),
                   "kv_pool_mb": float(kv_pool_mb)}
        if devices is not None:
            devices = list(devices)
            if device is None:
                device = devices[0].torch_device
        self.device = resolve_device(device)
        from llm_consensus_tpu_torch.parallel.mesh import local_devices

        self._devices = devices if devices is not None else local_devices(self.device)
        self.multihost_placement = bool(multihost_placement)
        # Placement: a mesh per preset (and the prefill role's under
        # disaggregation), and every position seen failing a model twice.
        self._meshes: dict = {}
        self._prefill_meshes: dict = {}
        self._bad_devices: set = set()
        self.checkpoint_dir = checkpoint_dir or None
        self.batch_streams = batch_streams
        self.pool_prefix = pool_prefix
        self.pool_prefix_min = pool_prefix_min
        self.prefill_budget = prefill_budget
        self.pool_bucket = pool_bucket
        self.preempt = preempt
        self.stream_interval = stream_interval
        self.ignore_eos = ignore_eos
        self._engines: dict[str, object] = {}
        self._batchers: dict[str, object] = {}
        self._lock = sanitizer.make_lock("providers.gpu")
        self._build_locks: dict[tuple[str, str], threading.Lock] = {}
        # Context-capacity cap: every engine's max_seq is at most this
        # (KV-cache memory is proportional to capacity).
        self._max_seq = max_seq
        # Chunked-prefill length of every engine (0: one-shot prefill).
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.stats = {"tokens": 0, "runs": 0}
        self._obs = obs.recorder()
        self._live = obs.live.metrics()
        self._bb = obs.blackbox.ring()
        self._faults = faults.plan()
        # Crash recovery, bound once: without a journal this stays None and
        # the batched submit path is the unsupervised one.
        self.journal = journal
        self._recovery = (EngineSupervisor(self, journal, engine_heartbeat_s, engine_restarts)
                          if journal is not None else None)
        # Speculative decoding: the draft map, the k ceiling it resets to,
        # and one (target engine, SpeculativeEngine or None) pair a preset.
        self._draft_map = _parse_draft_spec(draft)
        self._spec_k_default = max(1, spec_k)
        self._spec_k = self._spec_k_default
        self._spec_ngram = max(1, spec_ngram)
        self._spec_adapt = bool(spec_adapt)
        self._spec_governor = bool(spec_governor)
        self._spec_probe = int(spec_probe)
        self._specs: dict[str, tuple] = {}
        self._spec_batch_warned = False
        # The governor's brownout rung: drafted single-stream decode runs
        # plain while it is set.
        self._brownout_active = False
        self.swap_wait_s = swap_wait_s
        # utilization_stats' window: (time, batcher snapshot) and the last
        # entry per pool; a window advances after _UTIL_MIN_WINDOW_S, so
        # concurrent scrapers cannot shrink each other's window to noise.
        self._util_lock = sanitizer.make_lock("providers.gpu.util")
        self._util_prev: dict = {}
        self._util_last: dict = {}
        # Disaggregated prefill → decode: the settings and one (decode
        # engine, KVHandoff or None) pair a preset.
        self.disagg = {"disagg": bool(disagg),
                       "disagg_depth": max(1, int(disagg_depth)),
                       "disagg_wave": max(1, int(disagg_wave)),
                       "disagg_wait_s": float(disagg_wait_s),
                       "disagg_overlap": bool(disagg_overlap)}
        self.disagg_fraction = min(max(float(disagg_fraction), 0.05), 0.9)
        self._handoffs: dict[str, tuple] = {}
        self._disagg_pool_warned = False

    @classmethod
    def shared(cls, device: DeviceLike = None, *, batch_streams: int = 1,
               pool_prefix: bool = True, pool_prefix_min: int = 192, prefill_budget: int = 0,
               pool_bucket: bool = True, preempt: bool = True,
               checkpoint_dir: Optional[str] = None, prefix_cache: bool = True,
               prefix_cache_max_mb: float = PREFIX_CACHE_MAX_MB, kv_pool: bool = False,
               kv_pool_block: int = 64, kv_pool_mb: float = 256.0, journal: str = "",
               engine_heartbeat_s: float = DEFAULT_HEARTBEAT_S,
               engine_restarts: int = DEFAULT_MAX_RESTARTS, draft: str = "", spec_k: int = 4,
               spec_ngram: int = 3, spec_adapt: bool = True, spec_governor: bool = True,
               spec_probe: int = 64, max_seq: Optional[int] = None, prefill_chunk: int = 512,
               disagg: bool = False, disagg_depth: int = 8,
               disagg_wave: int = 4, disagg_wait_s: float = 30.0, disagg_overlap: bool = True,
               disagg_fraction: float = 0.5, multihost_placement: bool = True,
               **modes) -> "GPUProvider":
        """One provider per device, quantization modes, batching settings,
        checkpoint directory, prefix and KV pool settings and recovery
        settings for the process (the CLI's factory): a quantized run never
        reuses a bf16 engine, a batched run never an unbatched provider, a
        checkpointed run never random weights, a pooled run never a
        snapshot engine, a journaled run never an unsupervised provider. ``journal`` is the ``LLMC_JOURNAL`` setting: empty or
        ``"0"`` off, ``"1"`` in memory, else the directory the WAL files
        mirror to. The speculation settings join the key too (the CLI's
        ``--draft`` then reconfigures the shared provider with
        ``set_draft``), and so do the engines' context cap ``max_seq`` and
        chunked-prefill length (``LLMC_MAX_SEQ``, ``LLMC_PREFILL_CHUNK``) and
        the disaggregation settings (``LLMC_DISAGG*``)."""
        dev = resolve_device(device)
        modes = _resolve_modes(**modes)
        batching = {"batch_streams": batch_streams, "pool_prefix": bool(pool_prefix),
                    "pool_prefix_min": pool_prefix_min, "prefill_budget": max(0, prefill_budget),
                    "pool_bucket": bool(pool_bucket), "preempt": bool(preempt)}
        prefix = {"prefix_cache": bool(prefix_cache),
                  "prefix_cache_max_mb": float(prefix_cache_max_mb),
                  "kv_pool": bool(kv_pool), "kv_pool_block": int(kv_pool_block),
                  "kv_pool_mb": float(kv_pool_mb)}
        checkpoint_dir = checkpoint_dir or None
        journal = "" if journal in ("", "0") else journal
        recovery = {"engine_heartbeat_s": float(engine_heartbeat_s),
                    "engine_restarts": int(engine_restarts)}
        spec = {"draft": draft or "", "spec_k": int(spec_k), "spec_ngram": int(spec_ngram),
                "spec_adapt": bool(spec_adapt), "spec_governor": bool(spec_governor),
                "spec_probe": int(spec_probe)}
        engine = {"max_seq": max_seq or None, "prefill_chunk": max(0, int(prefill_chunk))}
        disagg = {"disagg": bool(disagg), "disagg_depth": int(disagg_depth), "disagg_wave": int(disagg_wave),
                  "disagg_wait_s": float(disagg_wait_s), "disagg_overlap": bool(disagg_overlap),
                  "disagg_fraction": float(disagg_fraction),
                  "multihost_placement": bool(multihost_placement)}
        key = (dev, tuple(sorted(modes.items())), tuple(sorted(batching.items())),
               checkpoint_dir, tuple(sorted(prefix.items())), journal,
               tuple(sorted(recovery.items())), tuple(sorted(spec.items())),
               tuple(sorted(engine.items())), tuple(sorted(disagg.items())))
        with cls._shared_lock:
            if key not in cls._shared:
                jr = StreamJournal(path=None if journal == "1" else journal) if journal else None
                cls._shared[key] = cls(device=dev, checkpoint_dir=checkpoint_dir, journal=jr,
                                       **batching, **prefix, **recovery, **spec, **engine,
                                       **disagg, **modes)
            return cls._shared[key]

    def prepare(self, models: list[str], judge: Optional[str], devices=None) -> None:
        """Build the CUDA kernels before the panel fan-out (so the first
        build never runs inside a model's deadline), and carve the devices
        (``devices``, else the provider's, every process's under a
        multi-controller run) into per-preset meshes with ``plan_panel``.
        A preset serving both roles keeps the judge's slice. Presets whose
        placement changed, or that the new plan lacks, drop their engine
        (and batcher and handoff), so a stale placement never overlaps a
        fresh one; a changed or dropped prefill role closes its handoff."""
        if self.device.type == "cuda":
            from llm_consensus_tpu_torch.ops.kernels.build import ensure_built

            ensure_built()
        from llm_consensus_tpu_torch.models.config import get_config
        from llm_consensus_tpu_torch.parallel import multicontroller as mc
        from llm_consensus_tpu_torch.parallel.mesh import plan_panel

        judge_preset = parse_model_name(judge) if judge and judge.startswith(SCHEME) else None
        panel = list(dict.fromkeys(parse_model_name(m) for m in models if m.startswith(SCHEME)))
        if not panel and judge_preset is None:
            return
        pool = list(devices) if devices is not None else mc.global_devices(self._devices)
        with self._lock:
            bad = set(self._bad_devices)
        survivors = [d for d in pool if d.id not in bad]
        if survivors:  # every position bad: plan as usual and fail honestly
            pool = survivors
        with warnings.catch_warnings():
            if len(pool) == 1:
                # One device has always served every model in turn: the
                # planner's time-multiplexing warning would say nothing new.
                warnings.simplefilter("ignore", RuntimeWarning)
            plan = plan_panel(
                [(p, get_config(p)) for p in panel if p != judge_preset],
                (judge_preset, get_config(judge_preset)) if judge_preset else None,
                devices=pool, multihost_placement=self.multihost_placement,
                disagg_fraction=self.disagg_fraction if self.disagg["disagg"] else None)
        meshes = {p.model: p.mesh for p in plan.placements}
        prefill = {p.model: p.prefill_mesh for p in plan.placements
                   if p.prefill_mesh is not None}
        stale = []
        with self._lock:
            for preset, mesh in meshes.items():
                old = self._meshes.get(preset)
                if old is not None and _mesh_key(old) == _mesh_key(mesh):
                    meshes[preset] = old  # same layout: the cached engine stays
                elif preset in self._engines and not _fits(self._engines[preset], mesh):
                    stale.append((preset, self._engines[preset]))
            stale += [(p, e) for p, e in self._engines.items() if p not in meshes]
            self._meshes = meshes
            for preset in set(self._prefill_meshes) | set(prefill):
                if _mesh_key(self._prefill_meshes.get(preset)) != _mesh_key(prefill.get(preset)):
                    ent = self._handoffs.pop(preset, None)
                    if ent is not None and ent[1] is not None:
                        ent[1].close()
            self._prefill_meshes = prefill
        for preset, engine in stale:
            self._evict(preset, engine)

    def placement(self, model: str):
        """The mesh the preset serving ``model`` is (or will be) placed on,
        or None before ``prepare`` placed it."""
        with self._lock:
            return self._meshes.get(parse_model_name(model))

    def engines(self) -> dict:
        """Built engines by preset (a snapshot)."""
        with self._lock:
            return dict(self._engines)

    def batcher_stats(self) -> dict:
        """Phase-accounting snapshot of every live batcher, keyed by preset
        (``ContinuousBatcher.snapshot``)."""
        with self._lock:
            batchers = dict(self._batchers)
        return {preset: b.snapshot() for preset, b in batchers.items()}

    def _engines_with_batchers(self) -> list:
        """Every live engine: the built ones and those the batchers run."""
        with self._lock:
            engines = dict(self._engines)
            for preset, batcher in self._batchers.items():
                engines.setdefault(preset, batcher.engine)
        return list(engines.items())

    def kv_stats(self) -> dict:
        """Each live engine's KV pool occupancy and traffic, keyed by preset
        (``KVPool.stats``, the JAX keys): ``metrics.json``'s ``kv`` block.
        Empty when no engine runs with the pool."""
        return {preset: eng._kv_pool.stats() for preset, eng in self._engines_with_batchers()
                if eng._kv_pool is not None}

    def kv_evict_cold(self, target_occupancy: float) -> int:
        """Evict cold KV-pool blocks down to ``target_occupancy`` in every
        live engine's pool; returns the blocks freed."""
        return sum(eng._kv_pool.evict_cold(target_occupancy)
                   for _preset, eng in self._engines_with_batchers()
                   if eng._kv_pool is not None)

    # -- the serving surface (serve/, pressure/) -------------------------------------

    _UTIL_MIN_WINDOW_S = 1.0

    def pressure_stats(self) -> dict:
        """Each pool's headroom (``ContinuousBatcher.pressure_snapshot``:
        live, cap, queued, preemptions), keyed by preset: the governor's
        batcher signal and the /statsz ``pressure`` block's pools. Under
        disaggregation a non-empty handoff queue folds into ``queued``
        (``handoff_queued``): prefill work already committed backpressures
        admission like batcher queueing."""
        with self._lock:
            handoffs = dict(self._handoffs)
        out: dict = {}
        for preset, batcher in self._batcher_entries():
            try:
                snap = batcher.pressure_snapshot()
            except Exception:  # noqa: BLE001 — stats must not throw
                continue
            ent = handoffs.get(preset)
            if ent is not None and ent[1] is not None:
                hq = ent[1].queued()
                if hq:
                    snap = dict(snap)
                    snap["handoff_queued"] = hq
                    snap["queued"] = snap.get("queued", 0) + hq
            out[preset] = snap
        return out

    def utilization_stats(self) -> dict:
        """Each pool's live decode rate, MFU and MBU over the window since
        the previous window advance (deltas of the batcher's decode
        accounting); calls inside ``_UTIL_MIN_WINDOW_S`` replay the last
        entry with the occupancy refreshed. A pool's first call reports
        only its live streams. MFU and MBU need a known card."""
        from llm_consensus_tpu_torch.utils.flops import batched_decode_mbu, decode_mfu

        now = time.monotonic()
        name = device_name(self.device)
        out: dict = {}
        for preset, batcher in self._batcher_entries():
            try:
                snap = batcher.snapshot()
                live = sum(1 for s in batcher._slots if s is not None)
                with self._util_lock:
                    prev = self._util_prev.get(preset)
                    if prev is not None and now - prev[0] < self._UTIL_MIN_WINDOW_S:
                        last = dict(self._util_last.get(preset, {}))
                        last["live_streams"] = live
                        out[preset] = last
                        continue
                    self._util_prev[preset] = (now, snap)
                entry: dict = {"live_streams": live}
                if prev is not None:
                    d_tok = snap["decode_tokens"] - prev[1]["decode_tokens"]
                    d_s = snap["decode_s"] - prev[1]["decode_s"]
                    if d_tok > 0 and d_s > 0:
                        eng = batcher.engine
                        tps = d_tok / d_s
                        entry["tokens_per_sec"] = round(tps, 2)
                        mfu = decode_mfu(eng.cfg, tps, name)
                        if mfu is not None:
                            entry["mfu"] = round(mfu, 4)
                        mbu = batched_decode_mbu(
                            eng.cfg, tps, max(1, live), name,
                            weight_bytes={"int8": 1, "int4": 0.5}.get(eng.quant, 2),
                            kv_bytes=1 if eng.kv_quant == "int8" else 2)
                        if mbu is not None:
                            entry["mbu"] = round(mbu, 4)
                    else:
                        entry["tokens_per_sec"] = 0.0
                with self._util_lock:
                    self._util_last[preset] = entry
                out[preset] = entry
            except Exception:  # noqa: BLE001 — stats must not throw
                continue
        # Per-role gauges: the prefill role's token rate and MFU from
        # window deltas of its handoff's prefill accounting, keyed
        # ``<preset>:prefill`` (prefill FLOPs a token ~ decode's 2 x params).
        with self._lock:
            handoffs = dict(self._handoffs)
        for preset, (_eng, handoff) in handoffs.items():
            if handoff is None:
                continue
            try:
                snap = handoff.snapshot()
                key = f"{preset}:prefill"
                with self._util_lock:
                    prev = self._util_prev.get(key)
                    if prev is not None and now - prev[0] < self._UTIL_MIN_WINDOW_S:
                        last = dict(self._util_last.get(key, {}))
                        last["queued"] = snap["queued"]
                        out[key] = last
                        continue
                    self._util_prev[key] = (now, snap)
                entry = {"role": "prefill", "queued": snap["queued"]}
                if prev is not None:
                    d_tok = snap["prefill_tokens"] - prev[1]["prefill_tokens"]
                    d_s = snap["prefill_s"] - prev[1]["prefill_s"]
                    if d_tok > 0 and d_s > 0:
                        tps = d_tok / d_s
                        entry["tokens_per_sec"] = round(tps, 2)
                        mfu = decode_mfu(handoff._pe.cfg, tps, name)
                        if mfu is not None:
                            entry["mfu"] = round(mfu, 4)
                    else:
                        entry["tokens_per_sec"] = 0.0
                with self._util_lock:
                    self._util_last[key] = entry
                out[key] = entry
            except Exception:  # noqa: BLE001 — stats must not throw
                continue
        return out

    def request_preempt(self, max_victims: int = 1) -> None:
        """The governor's ``preempt`` rung: nudge every pool to preempt its
        lowest-class streams for blocked higher-class work (each batcher
        checks the predicate itself; an unjustified nudge is a no-op)."""
        for _preset, batcher in self._batcher_entries():
            try:
                batcher.preempt(max_victims)
            except Exception:  # noqa: BLE001 — best-effort
                continue

    def set_brownout(self, on: bool) -> None:
        """The governor's ``brownout`` rung: drafted decode runs plain for
        its duration (single-stream speculation bypassed, pooled
        speculation in its plain windows)."""
        self._brownout_active = bool(on)
        for _preset, batcher in self._batcher_entries():
            try:
                batcher.set_brownout(on)
            except Exception:  # noqa: BLE001
                continue

    def swap_weights(self, model: str, params_or_path, version: Optional[int] = None, *,
                     wait: bool = False, meta: Optional[dict] = None) -> dict:
        """Hot-swap ``model``'s engine onto new weights: a parameter tree
        (``Engine.params`` layout) or a checkpoint directory of HF
        safetensors (``engine/checkpoint.py``, into the engine's
        quantization mode). ``version=None`` is one past the resident
        version. With the integrity plane on, a ``meta["params_digest"]``
        is checked against ``integrity.digest_tree`` of the tree as the
        checkpoint stores it first (``bit_flip@surface=ckpt`` corrupts the
        computed digest), then cast to the engine's dtype; a mismatch
        installs nothing. Returns the engine's swap stats with
        ``accepted`` (and ``rejected`` on a digest refusal)."""
        from llm_consensus_tpu_torch import integrity

        eng = self._engine_for(model)
        params = params_or_path
        m = dict(meta or {})
        plane = integrity.plane()
        want = m.get("params_digest")
        verify = plane is not None and isinstance(want, str)
        if isinstance(params_or_path, str):
            from llm_consensus_tpu_torch.engine.checkpoint import try_load_params

            # A digest covers the tree as written: read it back as stored
            # (dtype, no quantization) to check it; the engine's dtype and
            # mode are applied after.
            params = try_load_params(eng.cfg, params_or_path, device=eng.device,
                                     dtype=None if verify else eng.dtype,
                                     quant=None if verify else eng.quant)
            if params is None:
                raise FileNotFoundError(f"no safetensors checkpoint at {params_or_path!r}")
            m.setdefault("checkpoint", params_or_path)
        if verify:
            plane.check("ckpt")
            got = integrity.digest_tree(params)
            fplan = faults.plan()
            if fplan is not None:
                fs = fplan.fire("corrupt", surface="ckpt", model=model)
                if fs is not None and fs.kind == "bit_flip":
                    got = f"{(int(got, 16) ^ 1):08x}"
            if got != want:
                plane.failure("ckpt", f"params digest mismatch for {model} "
                                      f"(want {want}, got {got})")
                out = eng.swap_stats()
                out["accepted"] = False
                out["rejected"] = "params_digest_mismatch"
                return out
        if isinstance(params_or_path, str) and verify:
            params = _cast_tree(params, eng.dtype)
        if version is None:
            version = eng.weight_version + 1
        ok = eng.swap_weights(int(version), params, wait=wait, meta=m)
        out = eng.swap_stats()
        out["accepted"] = bool(ok)
        return out

    def rollback_weights(self, model: str, meta: Optional[dict] = None) -> Optional[int]:
        """Swap ``model`` back to its previous weights under a new version;
        None when there is none (a rollback never builds an engine)."""
        preset = parse_model_name(model)
        engines = dict(self._engines_with_batchers())
        eng = engines.get(preset)
        if eng is None:
            return None
        return eng.rollback_weights(meta)

    def swap_stats(self) -> dict:
        """Each live engine's weight version and swap counters, keyed by
        preset (``Engine.swap_stats``: the /statsz ``flywheel`` block)."""
        return {preset: eng.swap_stats() for preset, eng in self._engines_with_batchers()}

    def weight_version(self) -> int:
        """The highest resident weight version among the live engines."""
        return max((st.get("weight_version", 0) for st in self.swap_stats().values()),
                   default=0)

    def spec_stats(self) -> dict:
        """Speculative decoding per preset (the JAX keys): a single-stream
        ``SpeculativeEngine``'s cumulative stats, or a speculative pool's
        ``spec_snapshot``. Empty when nothing is drafted."""
        with self._lock:
            specs = dict(self._specs)
            batchers = dict(self._batchers)
        out: dict = {}
        for preset, (_eng, spec) in specs.items():
            if spec is None:
                continue
            out[preset] = {
                "kind": spec.drafter.kind, "k": spec.k, "rounds": spec.stats["rounds"],
                "accepted": spec.stats["accepted"],
                "mean_accepted": round(spec.mean_accepted, 3),
                "accept_ema": round(spec.last_accept_ema, 3),
                "governor_disables": spec.stats["governor_disables"],
                "collapse_faults": spec.stats["collapse_faults"],
            }
        for preset, batcher in batchers.items():
            snap = batcher.spec_snapshot()
            if snap:
                out[preset] = snap
        return out

    def set_draft(self, spec: str, k: Optional[int] = None) -> None:
        """Reconfigure drafting (the CLI's ``--draft`` and ``--spec-k``):
        cached pairs drop so the new map applies at once (target engines
        stay warm; live batchers keep the mode they were built with).
        ``k=None`` resets the ceiling to the provider's setting, so one
        in-process run's flags never leak into the next."""
        with self._lock:
            self._draft_map = _parse_draft_spec(spec)
            self._spec_k = max(1, k) if k is not None else self._spec_k_default
            self._specs.clear()

    def set_spec_k(self, k: int) -> None:
        """Set only the draft-length ceiling, keeping the draft map."""
        with self._lock:
            self._spec_k = max(1, k)
            self._specs.clear()

    def _batcher_entries(self) -> list:
        """Live ``(preset, batcher)`` pairs: the supervisor's watchdog reads
        them each poll."""
        with self._lock:
            return list(self._batchers.items())

    def recovery_stats(self) -> dict:
        """Engine liveness and recovery state: each pool's decode-heartbeat
        age, the worst age among BUSY pools (an idle pool legitimately stops
        beating), and, with supervision, the restart and replay counters and
        the journal depth (the JAX provider's keys)."""
        hearts: dict = {}
        worst = None
        for preset, batcher in self._batcher_entries():
            try:
                busy = batcher.busy()
                age = round(batcher.heartbeat_age(), 3)
            except Exception:  # noqa: BLE001 — liveness must not throw
                continue
            hearts[preset] = {"age_s": age, "busy": busy}
            if busy and (worst is None or age > worst):
                worst = age
        out: dict = {
            "state": "ok",
            "restarts": 0,
            "replayed_streams": 0,
            "journal_depth": 0,
            "heartbeats": hearts,
            "decode_heartbeat_age_s": worst,
        }
        if self._recovery is not None:
            sup = self._recovery.stats()
            out["state"] = sup["state"]
            out["restarts"] = sup["restarts"]
            out["replayed_streams"] = sup["replayed_streams"]
            out["journal_depth"] = sup["journal"]["depth"]
            out["heartbeat_s"] = sup["heartbeat_s"]
        return out

    def seal_stream(self, trace_id: Optional[str], model: Optional[str] = None) -> Optional[dict]:
        """Seal the open journal entry of the stream carrying ``trace_id``
        and return its migration resume payload, ``{"prompt_ids",
        "sampling", "tokens"}``: the frontier a destination replica replays
        through ``submit_ids`` (serve/elastic.py). Tokens a still-running
        decode appends after the seal are dropped from the snapshot and
        regenerated by the resume. None when the provider keeps no journal,
        no open entry matches, or more than one does (a panel of two
        models of this provider shares one trace id, and an entry does not
        record its model): the gateway then ships the emitted text."""
        if not trace_id or self.journal is None:
            return None
        from llm_consensus_tpu_torch.recovery.journal import _sampling_dict

        matches = [e for e in self.journal.active() if e.trace == trace_id and e.finish is None]
        if len(matches) != 1:
            return None
        entry = matches[0]
        tokens = entry.seal()
        return {"prompt_ids": list(entry.prompt_ids), "sampling": _sampling_dict(entry.sampling),
                "tokens": list(tokens)}

    def disagg_stats(self) -> dict:
        """Each live handoff's state, keyed by preset (``KVHandoff.snapshot``:
        the /statsz ``disagg`` block). Empty when disaggregation is off or no
        handoff is live."""
        with self._lock:
            handoffs = dict(self._handoffs)
        out: dict = {}
        for preset, (_eng, handoff) in handoffs.items():
            if handoff is None:
                continue
            try:
                out[preset] = handoff.snapshot()
            except Exception:  # noqa: BLE001 — stats must not throw
                continue
        return out

    def release(self) -> None:
        """Close every batcher and handoff and drop every engine with its
        prefix snapshot and open prefill sessions (weights and caches become
        collectible, even where a caller still holds an engine or a
        session)."""
        with self._lock:
            batchers = list(self._batchers.values())
            engines = list(self._engines.values())
            engines += [spec.draft for _, spec in self._specs.values()
                        if spec is not None and spec.draft is not None]
            handoffs = [h for _, h in self._handoffs.values() if h is not None]
            self._batchers.clear()
            self._engines.clear()
            self._specs.clear()
            self._handoffs.clear()
            self._meshes.clear()
            self._prefill_meshes.clear()
        for h in handoffs:
            h.close()
        for b in batchers:
            b.close()
        for engine in engines:
            engine.drop_prefix()
            engine.close_sessions()

    def _evict(self, preset: str, engine) -> None:
        """Drop ``preset``'s engine, batcher and handoff when they are still
        ``engine``'s (a concurrent retry may have published a healthy
        replacement already), closing the batcher and the handoff."""
        with self._lock:
            if self._engines.get(preset) is engine:
                del self._engines[preset]
            self._specs.pop(preset, None)
            hstale = self._handoffs.get(preset)
            if hstale is not None and hstale[0] is engine:
                del self._handoffs[preset]
                if hstale[1] is not None:
                    hstale[1].close()  # flips a flag, fails queued tickets
            batcher = self._batchers.get(preset)
            if batcher is not None and batcher.engine is engine:
                del self._batchers[preset]
            else:
                batcher = None
        if batcher is not None:
            batcher.close()

    def _get_or_build(self, table: dict, kind: str, preset: str, build):
        """``table[preset]``, built by ``build(preset)`` on first use.
        Construction happens outside the pool lock under a per-(kind,
        preset) lock, so distinct presets build concurrently while duplicate
        first requests for one preset share a single build (one engine, one
        pool cache)."""
        with self._lock:
            obj = table.get(preset)
            if obj is not None:
                return obj
            build_lock = self._build_locks.setdefault((kind, preset), sanitizer.make_lock(
                "providers.gpu.build" if kind == "engine" else "providers.gpu.build.batcher"))
        with build_lock:
            with self._lock:
                obj = table.get(preset)
            if obj is None:
                obj = build(preset)
                with self._lock:
                    table[preset] = obj
            return obj

    def _engine_for(self, model: str):
        """Get or lazily build the engine serving ``model``, on its preset's
        current mesh: an engine a concurrent ``prepare`` re-planned away
        from during its build is dropped and built again."""
        preset = parse_model_name(model)
        while True:
            engine = self._get_or_build(self._engines, "engine", preset, self._build_engine)
            with self._lock:
                mesh = self._meshes.get(preset)
                if mesh is None or _fits(engine, mesh):
                    return engine
                if self._engines.get(preset) is engine:
                    del self._engines[preset]

    def _replace_engine(self, preset: str, failed_ids: set):
        """Re-place ``preset`` off positions it failed on twice (the JAX
        provider's elastic re-placement): onto positions of this process no
        placement uses, else healthy ones another model holds
        (time-multiplexed, with a warning either way); returns the fresh
        engine, or None when no healthy position remains. The failed
        positions are remembered, so later plans route round them."""
        import warnings

        from llm_consensus_tpu_torch.models.config import get_config
        from llm_consensus_tpu_torch.parallel.mesh import (
            _pow2_floor, best_tp, host_groups, make_mesh)

        with self._lock:
            self._bad_devices.update(failed_ids)
            exclude = set(self._bad_devices)
            used = {d.id for p, m in self._meshes.items() if p != preset
                    for d in m.devices.flat}
        healthy = [d for d in self._devices if d.id not in exclude]
        if not healthy:
            return None
        spare = [d for d in healthy if d.id not in used]
        group = max(host_groups(spare if spare else healthy), key=len)
        tp = best_tp(get_config(preset), _pow2_floor(len(group)))
        mesh = make_mesh({"dp": 1, "tp": tp}, group[:tp])
        warnings.warn(f"re-placing {preset} after repeated failures on devices "
                      f"{sorted(failed_ids)} -> {sorted(d.id for d in mesh.devices.flat)}"
                      + ("" if spare else " (sharing a healthy model's slice)"),
                      RuntimeWarning, stacklevel=2)
        with self._lock:
            self._meshes[preset] = mesh
            engine = self._engines.get(preset)
        if engine is not None:
            self._evict(preset, engine)
        return self._engine_for(SCHEME + preset)

    def _build_engine(self, preset: str, max_seq: Optional[int] = None):
        if self._faults is not None:
            # build_fail[@preset=name]: the construction itself dies; the
            # retry ladder in query_stream builds once more.
            self._faults.check("build", preset=preset)
        from llm_consensus_tpu_torch.engine import Engine
        from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
        from llm_consensus_tpu_torch.engine.tokenizer import load_tokenizer
        from llm_consensus_tpu_torch.models.config import get_config

        cfg = get_config(preset)
        with self._lock:
            mesh = self._meshes.get(preset)
        params = tokenizer = None
        if self.checkpoint_dir:
            # On a mesh of several positions each position reads its own
            # shard of the checkpoint (the whole tree never lands anywhere).
            ckpt = os.path.join(self.checkpoint_dir, preset)
            params = try_load_params(cfg, ckpt, device=self.device, mesh=mesh,
                                     quant=self.modes["quant"])
            tokenizer = load_tokenizer(ckpt)
        cap = min(c for c in (self._max_seq, max_seq) if c) if (self._max_seq or max_seq) else None
        max_seq = min(cap, cfg.max_seq_len) if cap else None
        place = {"mesh": mesh} if mesh is not None else {"device": self.device}
        return Engine(cfg, params, max_seq=max_seq, tokenizer=tokenizer,
                      stream_interval=self.stream_interval, swap_wait_s=self.swap_wait_s,
                      prefill_chunk=self.prefill_chunk, **place, **self.modes, **self.prefix,
                      **self.kv)

    def _batcher_for(self, preset: str, engine):
        """The batcher serving ``preset`` over ``engine``, built once."""
        from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

        return self._get_or_build(self._batchers, "batcher", preset, lambda _: ContinuousBatcher(
            engine, max_batch=self.batch_streams, pool_prefix=self.pool_prefix,
            pool_prefix_min=self.pool_prefix_min, prefill_budget=self.prefill_budget,
            pool_bucket=self.pool_bucket, preempt=self.preempt, journal=self.journal,
            spec=self._spec_config_for(preset)))

    def _draft_preset_for(self, preset: str) -> Optional[str]:
        """The draft configured for ``preset`` (None: none, or itself)."""
        draft = self._draft_map.get(preset, self._draft_map.get("*"))
        return draft if draft and draft != preset else None

    def _spec_config_for(self, preset: str):
        """The ``SpecConfig`` of ``preset``'s pool, or None: only the
        buffer drafter (``lookup``) batches; model drafts stay single-stream."""
        if self._draft_preset_for(preset) != "lookup":
            return None
        from llm_consensus_tpu_torch.engine.speculative import SpecConfig

        return SpecConfig(kind="lookup", k=self._spec_k, ngram=self._spec_ngram,
                          adaptive=self._spec_adapt, governor=self._spec_governor,
                          probe_tokens=self._spec_probe)

    def _spec_for(self, preset: str, engine):
        """The ``SpeculativeEngine`` serving ``preset`` over ``engine`` (built
        once, dropped when the engine changes), or None when nothing drafts
        for it. A configuration error (an unknown draft preset, a draft of
        another vocabulary or device) turns speculation off for this engine
        with one warning; anything else (a kernel build or launch error, a
        CUDA error while the draft engine builds) propagates."""
        draft_preset = self._draft_preset_for(preset)
        if draft_preset is None:
            return None
        with self._lock:
            entry = self._specs.get(preset)
            if entry is not None and entry[0] is engine:
                return entry[1]
        from llm_consensus_tpu_torch.engine.speculative import (
            PromptLookupDrafter, SpeculativeEngine)

        settings = {"k": self._spec_k, "adaptive": self._spec_adapt,
                    "governor": self._spec_governor, "probe_tokens": self._spec_probe}
        try:
            if draft_preset == "lookup":
                spec = SpeculativeEngine(engine, PromptLookupDrafter(self._spec_ngram), **settings)
            else:
                parse_model_name(draft_preset)
                draft_engine = self._build_engine(draft_preset, max_seq=engine.max_seq)
                spec = SpeculativeEngine(engine, draft_engine, **settings)
        except (KeyError, ValueError) as exc:
            import warnings

            warnings.warn(f"speculative decoding disabled for {preset} (draft {draft_preset}): "
                          f"{exc}", RuntimeWarning, stacklevel=2)
            spec = None
        with self._lock:
            # Double-checked publish; the loser's draft is collectible.
            entry = self._specs.get(preset)
            if entry is not None and entry[0] is engine:
                return entry[1]
            self._specs[preset] = (engine, spec)
        return spec

    def _handoff_for(self, preset: str, engine):
        """The live :class:`KVHandoff` feeding ``engine``'s pool, built on
        first use, or None when disaggregation is off or cannot attach: the
        decode engine runs without the KV pool (warned once), or the build
        failed (warned; the classic path serves this engine generation). A
        handoff belongs to one engine: a rebuilt engine gets a fresh one."""
        if not self.disagg["disagg"]:
            return None
        with self._lock:
            ent = self._handoffs.get(preset)
            if ent is not None and ent[0] is engine:
                return ent[1]
        if getattr(engine, "_kv_pool", None) is None:
            if not self._disagg_pool_warned:
                self._disagg_pool_warned = True
                import warnings

                warnings.warn("disaggregation requested but the decode engine has no paged KV "
                              "pool (kv_pool=True, LLMC_KV_POOL=1): running the classic "
                              "interleaved-admission path", RuntimeWarning, stacklevel=2)
            with self._lock:
                self._handoffs.setdefault(preset, (engine, None))
            return None
        with self._lock:
            build_lock = self._build_locks.setdefault(
                ("handoff", preset), sanitizer.make_lock("providers.gpu.build.handoff"))
        with build_lock:
            with self._lock:
                ent = self._handoffs.get(preset)
                if ent is not None and ent[0] is engine:
                    return ent[1]
            stale = ent[1] if ent is not None else None
            try:
                from llm_consensus_tpu_torch.engine.handoff import KVHandoff

                # The pin holds a swap off while the decode tree is copied,
                # so the copy is tagged with the version it was taken from.
                version = engine.pin_weights()
                try:
                    pe = self._build_prefill_engine(preset, engine)
                finally:
                    engine.unpin_weights()
                handoff = KVHandoff(pe, engine, version=version,
                                    depth=self.disagg["disagg_depth"],
                                    wave_rows=self.disagg["disagg_wave"],
                                    wait_s=self.disagg["disagg_wait_s"], name=preset)
            except (KernelBuildError, KernelLaunchError):
                raise
            except Exception as exc:  # noqa: BLE001 — the classic path serves
                import warnings

                warnings.warn(f"disaggregated prefill disabled for {preset}: {exc}",
                              RuntimeWarning, stacklevel=2)
                handoff = None
            with self._lock:
                self._handoffs[preset] = (engine, handoff)
            if stale is not None:
                stale.close()
            return handoff

    def _build_prefill_engine(self, preset: str, engine):
        """The prefill role's engine, on its planned prefill mesh (sharded
        over it when it has several positions; the decode engine's device
        when the slice had one), with its own wave cache, no KV pool and no
        prefix snapshot. Where both roles are one unsharded engine's device
        it holds no tree at rest and each wave runs on the decode engine's
        pinned tree; otherwise it keeps the decode engine's weights (joined
        from its shards) in its own layout, and the handoff refreshes them
        after a swap (engine/handoff.py)."""
        if self._faults is not None:
            self._faults.check("build", preset=preset)
        from llm_consensus_tpu_torch.engine import Engine

        with self._lock:
            pmesh = self._prefill_meshes.get(preset)
        if pmesh is not None and pmesh.size > 1:
            place, device = {"mesh": pmesh}, pmesh.devices.flat[0].torch_device
        else:
            device = pmesh.devices.flat[0].torch_device if pmesh is not None else engine.device
            place = {"device": device}
        pe = Engine(engine.cfg, _to_device(engine.full_params(), device), dtype=engine.dtype,
                    max_seq=engine.max_seq, tokenizer=engine.tokenizer,
                    stream_interval=self.stream_interval, prefill_chunk=engine.prefill_chunk,
                    prefix_cache=False, kv_pool=False, **place, **self.modes)
        if not pe.sharded and not engine.sharded and pe.device == engine.device:
            pe._install(None)  # one tree: each wave runs on the decode engine's
        return pe

    def replan_disagg(self, preset: str, fraction: float) -> dict:
        """Re-carve ``preset``'s prefill share at run time (the JAX
        provider's elastic hook): ``split_roles`` over the union of its
        decode and prefill positions with the new ``fraction``, the prefill
        mesh republished. The decode mesh (the resident pool) never moves;
        a changed prefill role closes the stale handoff and the next request
        builds one on the new slice. The fraction sticks for later plans."""
        from llm_consensus_tpu_torch.models.config import get_config
        from llm_consensus_tpu_torch.parallel.mesh import split_role_meshes

        f = min(max(float(fraction), 0.05), 0.9)
        with self._lock:
            build_lock = self._build_locks.setdefault(
                ("handoff", preset), sanitizer.make_lock("providers.gpu.build.handoff"))
        with build_lock:
            with self._lock:
                self.disagg_fraction = f
                dmesh = self._meshes.get(preset)
                pmesh = self._prefill_meshes.get(preset)
            if dmesh is None or not self.disagg["disagg"]:
                return {"preset": preset, "fraction": f, "changed": False}
            seen: dict = {}
            for m in (dmesh, pmesh):
                for d in (m.devices.flat if m is not None else ()):
                    seen.setdefault(d.id, d)
            new_pmesh, _ = split_role_meshes(get_config(preset), [seen[i] for i in sorted(seen)],
                                             f)
            changed = _mesh_key(new_pmesh) != _mesh_key(pmesh)
            stale = None
            if changed:
                with self._lock:
                    if new_pmesh is None:
                        self._prefill_meshes.pop(preset, None)
                    else:
                        self._prefill_meshes[preset] = new_pmesh
                    stale = self._handoffs.pop(preset, None)
            if stale is not None and stale[1] is not None:
                stale[1].close()
            if self._obs is not None:
                self._obs.count("elastic.recarves")
                self._obs.instant("disagg_recarve", tid="provider", preset=preset,
                                  fraction=f, changed=changed)
            return {"preset": preset, "fraction": f, "changed": changed,
                    "prefill_devices": ([] if new_pmesh is None
                                        else [d.id for d in new_pmesh.devices.flat]),
                    "decode_devices": [d.id for d in dmesh.devices.flat]}

    def _recover_batcher(self, preset: str, failed_batcher):
        """Tear down a dead pool and rebuild engine and batcher: the
        supervisor's restart path, serialized per preset, so a pool's worth
        of concurrent stream failures costs ONE rebuild. Returns the fresh
        batcher.

        The dead batcher is abandoned, never joined: its threads may be
        wedged (the reason it is replaced), and ``close()``'s 120 s join
        would stall every replay behind it. The provider drops its
        references to the dead engine and batcher before the new engine is
        built, so once their threads have exited (at once after a crash; a
        wedged scheduler when it wakes) their weights and pool are
        collectible."""
        with self._lock:
            recover_lock = self._build_locks.setdefault(
                ("recover", preset), sanitizer.make_lock("providers.gpu.build.recover"))
        with recover_lock:
            with self._lock:
                current = self._batchers.get(preset)
            if (current is not None and current is not failed_batcher
                    and current.failed_exc is None):
                # A concurrent recovery already published a healthy pool:
                # this waiter replays onto it, no second rebuild.
                return current
            with self._lock:
                if current is not None and self._batchers.get(preset) is current:
                    del self._batchers[preset]
                if self._engines.get(preset) is failed_batcher.engine:
                    del self._engines[preset]
                hstale = self._handoffs.get(preset)
                if hstale is not None and hstale[0] is failed_batcher.engine:
                    del self._handoffs[preset]
                    if hstale[1] is not None:
                        hstale[1].close()
            failed_batcher.abandon(RuntimeError(
                f"engine pool for {preset!r} torn down for recovery"))
            current = failed_batcher = None
            batcher = self._batcher_for(preset, self._engine_for(preset))
            if self._recovery is not None:
                self._recovery.note_restart(preset)
            return batcher

    def _generate(self, engine, preset: str, prompt: str, sampling, ctx: Context, cb,
                  priority: Optional[int] = None, trace_id: Optional[str] = None,
                  resume: Optional[dict] = None):
        """One generate of ``prompt`` on ``engine``, through the preset's
        batcher (at ``priority``, None for NORMAL) when batching, supervised
        with a journal; a refused or cancelled submission runs
        single-stream. A drafted target runs its greedy and pure-temperature
        requests through its ``SpeculativeEngine`` (single-stream); with
        batching, ``lookup`` rides the pool's rounds and a model draft is
        ignored with one warning. The batcher's journal entry carries
        ``trace_id``. A migrated stream's ``resume`` payload with
        ``prompt_ids`` and ``tokens`` resubmits through the crash-replay
        path (``submit_ids(replay_ids=)``): the emitted tokens join the
        prefill and re-feed ``cb`` (the router's ledger burns them), and a
        failed resume re-decodes single-stream; a text-only payload runs
        the plain path."""
        draft_preset = self._draft_preset_for(preset)
        if draft_preset is not None:
            if self.batch_streams > 1:
                if draft_preset != "lookup" and not self._spec_batch_warned:
                    # Model drafts are single-stream: a drafted request
                    # must not silently bypass the batcher.
                    self._spec_batch_warned = True
                    import warnings

                    warnings.warn(
                        f"model draft configured for {preset!r} is ignored because stream "
                        f"batching is enabled (batch_streams={self.batch_streams}); use "
                        "--draft lookup for speculation that composes with continuous "
                        "batching", RuntimeWarning, stacklevel=2)
            elif self._brownout_active:
                pass  # pressure brownout: drafting off, the plain path below
            elif sampling.temperature == 0.0 or (sampling.top_k is None
                                                 and sampling.top_p is None):
                spec = self._spec_for(preset, engine)
                if spec is not None:
                    return spec.generate(prompt, sampling, ctx, on_text=cb)
        if self.batch_streams <= 1:
            return engine.generate(prompt, sampling, ctx, on_text=cb)
        batcher = self._batcher_for(preset, engine)
        priority = PRIORITY_NORMAL if priority is None else priority
        pids = (resume or {}).get("prompt_ids")
        toks = (resume or {}).get("tokens")
        if pids and toks:
            if self._obs is not None:
                self._obs.count("elastic.resumes")
                self._obs.instant("migrate_resume", tid="provider", preset=preset,
                                  trace=trace_id, replayed=len(toks))
            try:
                return batcher.submit_ids(list(pids), sampling, ctx=ctx, on_text=cb,
                                          replay_ids=tuple(toks), priority=priority,
                                          trace_id=trace_id).result()
            except (Cancelled, DeadlineExceeded, KernelBuildError, KernelLaunchError):
                raise
            except (CancelledError, Exception):  # noqa: BLE001 — re-decode instead
                return engine.generate(prompt, sampling, ctx, on_text=cb)
        handoff_trunc = False
        hand_ids, hand_tr = None, False
        if self.disagg["disagg"]:
            # Disaggregated admission: the prefill role establishes the
            # prompt's KV in the decode pool BEFORE the submit, so the
            # batcher's admission gathers it and prefills the tail. Every
            # failure (no handoff, a full queue, a stall past the wait, a
            # crashed wave) takes the classic path below. The prompt is
            # encoded and budgeted once, here, for both.
            handoff = self._handoff_for(preset, engine)
            if handoff is not None:
                try:
                    hand_ids, hand_tr = engine._budget_prompt(
                        engine.tokenizer.encode(prompt), sampling.max_new_tokens)
                    wait = handoff.run_overlapped if self.disagg["disagg_overlap"] else handoff.run
                    _off, handoff_trunc = wait(hand_ids, priority=priority, ctx=ctx)
                except (Cancelled, DeadlineExceeded):
                    raise
                except Exception:  # noqa: BLE001 — the classic path
                    hand_ids = None

        def with_handoff_kv(result):
            # A publish the pool truncated on the handoff path degrades this
            # request's reuse as a local retain's would.
            if handoff_trunc:
                result.kv_truncated = True
            return result

        if self._recovery is not None:
            # Supervised: journaled submit; a pool that dies mid-decode
            # becomes a rebuild and a replay instead of a failed request.
            # The supervisor owns the fallbacks the path below has inline.
            return with_handoff_kv(self._recovery.run_stream(
                preset, batcher, prompt, sampling, ctx, cb, priority=priority,
                trace_id=trace_id))
        try:
            if hand_ids is not None:
                fut = batcher.submit_ids(hand_ids, sampling, ctx=ctx, on_text=cb,
                                         truncated=hand_tr, priority=priority, trace_id=trace_id)
            else:
                fut = batcher.submit(prompt, sampling, ctx, on_text=cb, priority=priority,
                                     trace_id=trace_id)
        except (KernelBuildError, KernelLaunchError):
            raise
        except (RuntimeError, ValueError):
            # A closed batcher (a shutdown or eviction race): direct path.
            return with_handoff_kv(engine.generate(prompt, sampling, ctx, on_text=cb))
        try:
            return with_handoff_kv(fut.result())
        except CancelledError:
            # A concurrent close cancelled the queued submission: a benign
            # race, not an engine failure.
            return with_handoff_kv(engine.generate(prompt, sampling, ctx, on_text=cb))

    def query(self, ctx: Context, req: Request) -> Response:
        return self.query_stream(ctx, req, None)

    def query_stream(
        self, ctx: Context, req: Request, callback: Optional[StreamCallback]
    ) -> Response:
        from llm_consensus_tpu_torch.engine import SamplingParams
        from llm_consensus_tpu_torch.utils.flops import decode_mbu, decode_mfu

        try:
            engine = self._engine_for(req.model)
        except _NO_RETRY:
            raise
        except Exception:  # noqa: BLE001 — a transient build failure: one more build
            ctx.raise_if_done()
            engine = self._engine_for(req.model)
        start = time.monotonic()
        t0_ns = time.monotonic_ns() if self._obs is not None or self._bb is not None else 0
        sampling = SamplingParams(
            max_new_tokens=(
                req.max_tokens if req.max_tokens is not None else DEFAULT_MAX_NEW_TOKENS
            ),
            temperature=req.temperature if req.temperature is not None else 0.0,
            ignore_eos=self.ignore_eos,
        )
        prompt = req.prompt
        if req.system:
            # The plain engine has no chat template; fold the system
            # prompt ahead of the user prompt.
            prompt = f"{req.system}\n\n{req.prompt}"
        streamed = [0]
        cb = callback
        if callback is not None:
            def cb(chunk, _callback=callback):
                streamed[0] += 1
                _callback(chunk)
        preset = parse_model_name(req.model)
        retry = False
        gen = {"priority": req.priority, "trace_id": req.trace_id, "resume": req.resume}
        try:
            result = self._generate(engine, preset, prompt, sampling, ctx, cb, **gen)
        except _NO_RETRY:
            raise
        except Exception:  # noqa: BLE001 — one rebuild, unless text already streamed
            if streamed[0]:
                raise
            retry = True
        if retry:
            # Outside the except block: the traceback no longer pins the
            # failed engine's frames, so it is collectible before the
            # fresh one allocates.
            ctx.raise_if_done()  # never pay a rebuild for a doomed request
            failed_ids = _mesh_ids(engine)
            self._evict(preset, engine)
            engine = None
            gc.collect()
            replace = False
            try:
                engine = self._engine_for(req.model)
                result = self._generate(engine, preset, prompt, sampling, ctx, cb, **gen)
            except _NO_RETRY:
                raise
            except Exception:  # noqa: BLE001 — the placement is suspect
                # A second failure (the rebuild or its generate): re-place
                # the model on healthy positions and try once more; with
                # none (one card) the model fails.
                if engine is not None:
                    failed_ids |= _mesh_ids(engine)
                if streamed[0] or not failed_ids or len(self._devices) < 2:
                    raise
                replace = True
            if replace:
                ctx.raise_if_done()
                engine = None
                gc.collect()
                engine = self._replace_engine(preset, failed_ids)
                if engine is None:
                    raise RuntimeError(f"{preset}: no healthy device left to re-place it on")
                result = self._generate(engine, preset, prompt, sampling, ctx, cb, **gen)
        with self._lock:
            self.stats["tokens"] += len(result.token_ids)
            self.stats["runs"] += 1
        if result.finish_reason in ("deadline", "cancelled"):
            # A timed-out model is a failed model, not a partial success.
            ctx.raise_if_done()

        # Steady-state decode rate from the engine's fetch-boundary clock;
        # None when the run fit one chunk (too short to measure).
        tokens_per_sec = mfu = mbu = None
        if result.decode_s > 0 and result.decode_tokens > 0:
            tokens_per_sec = result.decode_tokens / result.decode_s
            kind = device_name(self.device)
            mid_context = result.prompt_tokens + len(result.token_ids) // 2
            # Per card: virtual positions sharing one card count it once.
            n_dev = (len({d.torch_device for d in engine.mesh.devices.flat})
                     if engine.mesh is not None else 1)
            cards = {"n_devices": n_dev} if n_dev > 1 else {}
            mfu = decode_mfu(engine.cfg, tokens_per_sec, kind, context_len=mid_context, **cards)
            # Bytes per weight and per cache element of this engine's modes
            # (the JAX provider's widths).
            itemsize = engine.dtype.itemsize
            mbu = decode_mbu(
                engine.cfg, tokens_per_sec, kind, context_len=mid_context,
                weight_bytes={"int8": 1, "int4": 0.5}.get(engine.quant, itemsize),
                kv_bytes=1 if engine.kv_quant == "int8" else itemsize, **cards,
            )
        for rec in (self._obs, self._bb):
            if rec is not None:
                rec.complete("engine_stream", t0_ns, tid="engine", model=req.model,
                             trace=req.trace_id, tokens=len(result.token_ids))
        if self._live is not None and result.token_ids:
            # Steady-state decode cadence when the engine measured one, else
            # the whole request's mean per token.
            if result.decode_tokens and result.decode_s > 0:
                per_tok = result.decode_s / result.decode_tokens
            else:
                per_tok = (time.monotonic() - start) / len(result.token_ids)
            self._live.observe("token_latency", per_tok,
                               outcome="preempted" if getattr(result, "preempted", False) else "ok",
                               **{"class": class_label(PRIORITY_NORMAL if req.priority is None
                                                       else req.priority)})
        if self._obs is not None and tokens_per_sec is not None:
            # Run aggregates: the footer divides the sums; MFU re-weights by
            # the tokens that reported one.
            self._obs.count("decode_tokens", result.decode_tokens)
            self._obs.count("decode_s", result.decode_s)
            if mfu is not None:
                self._obs.count("mfu_weighted_tokens", mfu * result.decode_tokens)
                self._obs.count("mfu_tokens", result.decode_tokens)
        return Response(
            model=req.model,
            content=result.text,
            provider=self.name,
            latency_ms=(time.monotonic() - start) * 1000,
            truncated=result.truncated_prompt,
            tokens=len(result.token_ids),
            tokens_per_sec=tokens_per_sec,
            mfu=mfu,
            mbu=mbu,
            spec=getattr(result, "spec", None),
            kv={"truncated": True} if getattr(result, "kv_truncated", False) else None,
        )
