"""On-device inference engine: prefill + streamed decode over a KV cache
(port of ``llm_consensus_tpu/engine/engine.py``, single-stream ``Engine``).

  * **Prefill**: a prompt of up to ``prefill_chunk`` tokens is padded to a
    power-of-two bucket and prefilled in one shot from position 0 (the
    flash kernel); a longer prompt is prefilled in fixed chunks at a
    running start (the plain attention op over the prompt's bucket).
    Padding junk lands at cache slots ≥ the prompt length, which decode
    overwrites before its frontier reaches them.
  * **Decode** runs in chunks of ``stream_interval`` one-token steps with
    one chunk of lookahead: chunk N+1 is enqueued on the card before chunk
    N's tokens are fetched. Sampling happens on the device and the step's
    position lives in device memory, so there is no host sync per step:
    the host copies each chunk's token ids back once (pinned memory, an
    event per chunk) and detects EOS there, dropping up to one chunk of
    overshoot.
  * **Cancellation**: the run context is checked at every chunk boundary;
    a deadline or cancel returns the partial result with ``finish_reason``
    set.

Quantization (ops/quant.py): ``quant`` stores the matmul weights as int8
(per-channel scales) or int4 (group-wise), ``kv_quant="int8"`` the KV cache
as int8 codes with per-row scales, which the decode kernel reads directly;
``w8a8`` runs int8 x int8 matmuls (int8 weights only) and ``decode_w8a8``
int8 x int8 decode scores (int8 cache, GQA group 2 to 4). The engine reads
no environment: the CLI reads the JAX package's knobs for these modes.

For the continuous batcher (engine/batcher.py) the engine also prefills
admission waves of k rows in one pass (:class:`AdmissionPrefill`: full
prompts through the flash kernel at B = k, or in chunks; or suffixes
against the pool's shared prefix), one-shot or paced a token budget at a
time between decode chunks (``Engine.admission_session``), and decodes a chunk of steps over
right-aligned rows (``row_start``) with an optional shared prefix
(:meth:`Engine._decode_chunk`).

Telemetry (obs/): the recorder, the attribution ledger and the roofline
ledger are bound at construction. A prefill and each decode chunk record
their stream interval (obs/attrib.py :class:`DeviceWall`), read at the fetch,
into the attribution ledger; the first dispatch of each shape key runs one
step under a roofline capture, which counts that step's first layer (its
host time is taken out of the interval); spans ``prefill``, ``decode`` and ``fetch``
land on the recorder. With every plane off the loops consult only the
bound Nones, once per chunk.

Prefix snapshot reuse (the JAX engine's, on by default): every
single-stream generate keeps its finished cache as the engine's one
snapshot, paired with the ids whose KV it holds; the next prompt that
shares at least one prefill chunk with them restores that prefix (one
masked copy, :func:`_restore_prefix`) and prefills only its tail in
chunks. A full-prompt chunked admission wave whose rows share a chunk
forks the snapshot the same way (:func:`_fork_prefix`) and retains its row
0. Snapshots above ``prefix_cache_max_mb`` are never kept.

:class:`PrefillSession` (``Engine.prefill_session()``) prefills a prompt
incrementally as its pieces become known (the judge-overlap path,
consensus/overlap.py), then decodes through the same loop as ``generate``.

Fault injection (faults/), bound at construction as in the JAX engine:
``check("prefill")`` before every prefill (``_prefill_ids`` and each
:class:`AdmissionPrefill`) and ``check("decode")`` before every decode chunk
of the streamed loop. With no plan installed each site is one ``is not
None`` check.

The integrity plane's finite-logit sentinel lives in
:meth:`Engine._decode_chunk` (``sentinel=True``): the continuous batcher
asks for it when the plane is on.

The cross-request paged KV pool (kv/, ``kv_pool=True``) replaces the
snapshot: ``_reusable_prefix`` becomes a radix match and a block gather
(restored by masking the private gathered cache in place,
:func:`_restore_prefix_owned`), ``_retain_prefix`` a block publish whose
truncation sets ``GenerateResult.kv_truncated``; an admission wave forks a
pool hit and, under the pool, retains a lone-row wave too, unless the
radix already covers its row 0. The ids published are the ones whose KV
the decode loop wrote (``(prompt + emitted)[:pos]``), as for the snapshot.

Live weight hot-swap (the JAX engine's): :meth:`Engine.pin_weights` /
:meth:`Engine.unpin_weights` refcount the resident weights; every
single-stream generate, every :class:`PrefillSession` generate and every
batched stream (the batcher pins at admission) holds a pin, so it finishes
on the weights it started with. :meth:`Engine.swap_weights` prepares the
new tree (on the engine's device, quantized to its resident mode) outside
the swap lock, then flips at once when nothing is pinned or parks it in
the double buffer until the last unpin; the previous tree stays resident
for :meth:`Engine.rollback_weights`, which installs it under a new
monotone version. After a flip the prefix snapshot drops and the KV pool
evicts every cold block (their KV came from the old weights). The ``swap``
fault site fires ``swap_mid_stream`` at apply and ``canary_regress`` on a
swapped-in (version > 0) engine's decode chunks.

Tensor, expert and sequence parallelism (``mesh=``, the JAX engine's):
the engine holds one weight shard per mesh position (parallel/sharding.py)
and runs models/transformer.py ``forward_sharded`` over them, each shard's
compute issued on its own position's device, the partial sums reduced by
the engine; the kernels launch per shard on its head slice where the JAX
gate lets them (a tp-only mesh whose degree divides both head counts). On
a mesh with an ``sp`` axis a prompt whose bucket splits over it prefills by
ring attention (``forward_ring_prefill``). A sharded engine serves every
path the unsharded one does: its caches are lists of per-shard caches
(one per attention position, each of its heads, :meth:`Engine.new_cache`),
which the prefix snapshot copies and restores shard by shard and the
batcher, the KV pool (one arena per shard) and the handoff move in
lockstep; the batched forms (``row_start``, the shared prefix, the
speculative bitmap) run through ``forward_sharded``; the weight swap
shards the incoming tree as the constructor does and flips every group's
shards at once. ``generate_batch`` is the JAX engine's static batch: left-
padded rows with per-row ``row_start``, the prefill on the plain op and
every decode step on the decode kernel with the row starts.
"""

from __future__ import annotations

import time
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.engine.tokenizer import StreamDecoder, load_tokenizer
from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.kv import pool_for
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, cache_map, forward, forward_ring_prefill, forward_sharded, init_kv_cache,
    init_params, layer_views, param_leaves)
from llm_consensus_tpu_torch.obs.attrib import DeviceWall
from llm_consensus_tpu_torch.ops.kernels.decode_attention import w8a8_supported
from llm_consensus_tpu_torch.ops.quant import (
    KV_MODES, WEIGHT_MODES, qmatmul, quantize_params, resolve_int4_impl, resolve_mode)
from llm_consensus_tpu_torch.ops.sampling import sample_token
from llm_consensus_tpu_torch.utils.context import Context
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device
from llm_consensus_tpu_torch.utils.flops import (
    decode_bytes_per_token, flops_per_token, param_count)


@dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    ignore_eos: bool = False  # benchmarking: fixed-length decode


@dataclass
class GenerateResult:
    token_ids: list[int]
    text: str
    finish_reason: str  # "eos" | "length" | "deadline" | "cancelled"
    prompt_tokens: int
    latency_ms: float
    truncated_prompt: bool = False
    # Steady-state decode measurement (tokens after the first chunk fetch,
    # which forces prefill + first-chunk completion); zero when the whole
    # generation fit in one chunk.
    decode_tokens: int = 0
    decode_s: float = 0.0
    # Preempted and resumed at least once (the continuous batcher's
    # priority preemption).
    preempted: bool = False
    # The KV pool truncated this generation's publish (arena exhausted or
    # squeezed): reuse of this context is degraded.
    kv_truncated: bool = False
    # Speculative decoding's per-call summary (engine/speculative.py):
    # drafter kind, k, rounds, accepted tokens, governor state; None on the
    # plain path.
    spec: Optional[dict] = None


# Decode attention width: buckets of this granule over the causal frontier
# (the JAX engine's LLMC_DECODE_KV_MIN default).
DECODE_KV_MIN = 128
# The JAX engine's LLMC_PREFIX_CACHE_MAX_MB default (MB = 1e6 bytes): the
# largest prefix snapshot the engine keeps and the largest dense
# shared-prefix copy the batcher may hold.
PREFIX_CACHE_MAX_MB = 2048.0


def _bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, cap)


def _seq_axis(leaf: torch.Tensor) -> int:
    """The sequence axis of a cache leaf: 2 in the [L, B, S, Hkv, dh]
    stacks (bf16, and the int8 codes ``q8``), 3 in the int8 scales ``s``
    [L, B, Hkv, S] (seq-minor, as the decode kernels read them)."""
    return 2 if leaf.dim() == 5 else 3


def _mask_beyond(src: torch.Tensor, n_valid: int) -> torch.Tensor:
    """A fresh copy of ``src`` with its positions >= ``n_valid`` zeroed
    along its sequence axis: the one owner of the prefix-restore masking
    (:func:`_restore_prefix`, :func:`_fork_prefix`). Never a view: the
    forward writes caches in place, and the source is a snapshot that
    later reuses read again."""
    ax = _seq_axis(src)
    out = torch.empty_like(src)
    out.narrow(ax, 0, n_valid).copy_(src.narrow(ax, 0, n_valid))
    out.narrow(ax, n_valid, src.shape[ax] - n_valid).zero_()
    return out


def _restore_prefix(saved: dict, n_valid: int) -> dict:
    """A working cache from a prefix snapshot: positions < ``n_valid`` keep
    the saved K/V, the rest are zero. One masked copy of the cache replaces
    prefilling the shared prefix again; the snapshot is only read."""
    return cache_map(lambda src: _mask_beyond(src, n_valid), saved)


def _restore_prefix_owned(saved: dict, n_valid: int) -> dict:
    """:func:`_restore_prefix` for a PRIVATE input (the KV pool's freshly
    gathered cache, dropped right after): its positions >= ``n_valid`` are
    zeroed in place and the same cache is returned, so a pool hit holds one
    full-capacity cache, not two. The snapshot path keeps the copying form:
    its input is read again by later reuses."""
    def mask(src: torch.Tensor) -> torch.Tensor:
        ax = _seq_axis(src)
        src.narrow(ax, n_valid, src.shape[ax] - n_valid).zero_()
        return src

    return cache_map(mask, saved)


def _fork_prefix(saved: dict, n_valid: int, k: int, width: int) -> dict:
    """A [1, max_seq] prefix snapshot as a [k, width] admission-wave cache:
    its first ``width`` positions, zero from ``n_valid`` on, in each of the
    k rows. The copy costs k x width slots; the wave saves computing the
    shared prefix chunks through the model."""
    def leaf(src):
        ax = _seq_axis(src)
        shape = list(src.shape)
        shape[1], shape[ax] = k, width
        out = torch.zeros(shape, dtype=src.dtype, device=src.device)
        out.narrow(ax, 0, n_valid).copy_(src.narrow(ax, 0, n_valid))  # broadcast over rows
        return out

    return cache_map(leaf, saved)


def _extract_row0(template: dict, pcache: dict, width: int) -> dict:
    """Row 0 of a [k, width] admission-wave cache copied into ``template``,
    a fresh full-capacity [1, max_seq] cache, which is returned."""
    def copy(dst, src):
        ax = _seq_axis(src)
        dst.narrow(ax, 0, width).copy_(src[:, :1].narrow(ax, 0, width))
        return dst

    return cache_map(copy, template, pcache)


def _cache_nbytes(cache) -> int:
    total = []
    cache_map(lambda leaf: total.append(leaf.numel() * leaf.element_size()), cache)
    return sum(total)


class _Fetch:
    """One chunk's token ids on their way to the host: the device tensor,
    its host copy, and (on a card) the event that marks the copy done.
    ``wall`` is the chunk's :class:`DeviceWall`, closed by that event.
    ``verdict`` (the finite-logit sentinel's [B] bools, or None) is copied
    beside the tokens, before the same event."""

    def __init__(self, toks: torch.Tensor, wall: Optional[DeviceWall] = None,
                 verdict: Optional[torch.Tensor] = None) -> None:
        if toks.is_cuda:
            self.host = toks.to("cpu", non_blocking=True)  # pinned destination
            self.host_verdict = (verdict.to("cpu", non_blocking=True)
                                 if verdict is not None else None)
            self.event = torch.cuda.Event(enable_timing=wall is not None)
            self.event.record()
        else:
            self.host = toks
            self.host_verdict = verdict
            self.event = None
        self.wall = wall.stop(self.event) if wall is not None else None

    def values(self) -> list:
        """The host copy as (nested) Python lists, once the copy is done."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()

    def verdict(self) -> Optional[list]:
        """The sentinel's per-row verdict (True: every logit finite), read
        after :meth:`values`; None without a sentinel."""
        return self.host_verdict.tolist() if self.host_verdict is not None else None

    def ids(self) -> list[int]:
        return [int(t) for t in self.values()]


class Engine:
    """Single-model inference engine (one decode stream per generate call).

    ``params`` defaults to random initialization on the device from
    ``seed``. ``device=None`` means the current CUDA card and raises when
    there is none; pass ``device="cpu"`` to run on the CPU (the kernels'
    plain versions). ``prefill_chunk`` and ``stream_interval`` take the
    JAX engine's knob defaults. One-shot prefill and decode go through the
    kernels (``attn_impl="flash"``), the chunked prefill through the plain
    attention op, as in the JAX engine on a TPU.

    ``quant`` ("int8" | "int4") and ``kv_quant`` ("int8") take "bf16" or
    "none" for off, and an unknown mode raises ``ValueError`` before any
    parameter is built. ``w8a8`` holds only with int8 weights;
    ``decode_w8a8`` only with the int8 cache and a GQA group of 2 to 4 (the
    JAX kernel's dense-GQA form); ``int4_impl`` is the int4 matmul lowering
    ("auto" | "nibble", checked like the modes). Random-init weights are
    quantized leaf by leaf as they are drawn; given ``params`` are
    quantized when ``quant`` is set (already quantized leaves pass through).
    ``prefix_cache`` turns prefix snapshot reuse on (the JAX engine's
    ``LLMC_PREFIX_CACHE`` default); it needs chunked prefill
    (``prefill_chunk`` > 0). ``prefix_cache_max_mb`` (MB = 1e6 bytes)
    bounds the snapshot the engine keeps (a larger cache is never
    retained) and the dense shared-prefix KV a continuous batcher over
    this engine may establish. ``kv_pool`` replaces the snapshot with the
    cross-request paged KV pool (kv/; off by default, as the JAX
    ``LLMC_KV_POOL``): ``kv_pool_block`` tokens a block, an arena of
    ``kv_pool_mb`` MB, whose budget replaces the snapshot's byte cap.
    ``tokenizer`` defaults to the byte-level one (a checkpoint's own comes
    from ``load_tokenizer``).

    ``mesh`` (parallel/mesh.py) pins the engine to those positions: with
    more than one, the weights (``params`` on the first position's device,
    or drawn there from ``seed``, quantized first when ``quant`` is set)
    split as parallel/sharding.py ``param_specs`` says, one shard per
    position (positions of a ``dp`` axis beyond its first index hold none:
    one stream is one batch row), and the engine runs on the first
    position's device; ``device`` must then be None. A one-position mesh is
    that position's device.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[dict] = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
        max_seq: Optional[int] = None,
        seed: int = 0,
        stream_interval: int = 16,
        prefill_chunk: int = 512,
        device: DeviceLike = None,
        quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        w8a8: bool = False,
        decode_w8a8: bool = False,
        int4_impl: str = "auto",
        prefix_cache: bool = True,
        prefix_cache_max_mb: float = PREFIX_CACHE_MAX_MB,
        tokenizer=None,
        kv_pool: bool = False,
        kv_pool_block: int = 64,
        kv_pool_mb: float = 256.0,
        swap_wait_s: float = 30.0,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both")
            device = mesh.devices.flat[0].torch_device
        self.prefix_max_bytes = prefix_cache_max_mb * 1e6
        self.quant = resolve_mode(quant, "quant", WEIGHT_MODES)
        self.kv_quant = resolve_mode(kv_quant, "kv_quant", KV_MODES)
        self.w8a8 = bool(w8a8) and self.quant == "int8"
        self.decode_w8a8 = (
            bool(decode_w8a8) and self.kv_quant == "int8"
            and w8a8_supported(cfg.n_heads, cfg.n_kv_heads)
        )
        # The matmul of every projection, its modes bound once.
        self._mm = partial(qmatmul, w8a8=self.w8a8,
                           int4_nibble=resolve_int4_impl(int4_impl) == "nibble")
        self.device = resolve_device(device)
        self.max_seq = max_seq or cfg.max_seq_len
        self.tokenizer = tokenizer if tokenizer is not None else load_tokenizer(None)
        self.stream_interval = max(1, stream_interval)
        self.dtype = dtype
        # Past this length a prompt prefills in fixed chunks; 0 disables.
        self.prefill_chunk = max(0, prefill_chunk)
        if params is None:
            params = init_params(cfg, seed, device=self.device, dtype=dtype, quant=self.quant)
        else:
            for name, w in param_leaves(params):
                if w.device != self.device:
                    raise ValueError(
                        f"param {name} is on {w.device}, the engine on {self.device}"
                    )
            if self.quant is not None:
                params = quantize_params(params, self.quant)
        # Sharded: one ShardGroup per sp position, the full tree dropped.
        self._groups: Optional[list] = None
        self._shards: Optional[list] = None
        if mesh is not None and mesh.size > 1:
            from llm_consensus_tpu_torch.parallel.sharding import param_specs

            self._specs = param_specs(cfg, mesh)
            self._shards = self._shard(params)
            params = None
            self._groups = [ShardGroup(cfg, mesh, self._shards, self._specs,
                                       {"dp": 0, "sp": s})
                            for s in range(mesh.shape.get("sp", 1))]
        self.params = params
        self._layers = layer_views(params) if params is not None else None
        # Weight hot-swap state. Pins refcount the resident weights (taken
        # at stream admission, released at retirement) so every in-flight
        # stream finishes on the buffer it started with; pin/unpin never
        # block, and the flip rides whichever unpin drains the count to
        # zero. The swap lock is a leaf: nothing under it calls out.
        self._swap_lock = sanitizer.make_lock("engine.swap")
        self._swap_cv = sanitizer.make_condition("engine.swap", self._swap_lock)
        self.swap_wait_s = swap_wait_s  # LLMC_SWAP_WAIT_S
        self.weight_version = 0
        self.weight_meta: dict = {}
        self._pins = 0
        self._pending_swap: Optional[tuple] = None  # (version, params, meta)
        # True from a flip until its cache hygiene (_post_flip) is done: the
        # old weights' KV is still cached meanwhile.
        self._flipping = False
        self._prev_weights: Optional[tuple] = None  # (version, params)
        self._swap_requested = 0.0
        self._swap_stats = {
            "swaps": 0, "swap_rejects": 0, "swap_queued": 0,
            "rollbacks": 0, "last_vacate_ms": 0.0, "last_prep_ms": 0.0,
        }
        # Prefix snapshot: the ids and the [1, max_seq] cache holding their
        # KV, read and written as a pair under the lock. Off with the
        # switch, with chunking off (reuse prefills its tail in chunks), or
        # when a snapshot would pass the byte cap (a 131,072-slot cache
        # must not double its memory); under the KV pool the arena's budget
        # replaces that cap.
        self.kv_pool_requested = bool(kv_pool)
        self.kv_pool_block = int(kv_pool_block)
        self.kv_pool_mb = float(kv_pool_mb)
        snapshot_bytes = _cache_nbytes(init_kv_cache(
            cfg, batch=1, max_seq=self.max_seq, device=torch.device("meta"), dtype=dtype,
            quant=self.kv_quant))
        self.prefix_cache_enabled = (
            bool(prefix_cache) and self.prefill_chunk > 0
            and (self.kv_pool_requested or snapshot_bytes <= self.prefix_max_bytes))
        self._prefix_ids: Optional[tuple] = None
        self._prefix_cache: Optional[dict] = None
        self._prefix_lock = sanitizer.make_lock("engine.prefix")
        self._sessions: "weakref.WeakSet[PrefillSession]" = weakref.WeakSet()
        # Telemetry planes (obs/), bound once: a plane off costs the hot
        # loops one None check per chunk.
        self._obs = obs.recorder()
        self._attrib = obs.attrib.ledger()
        self._roofline = obs.roofline.ledger()
        # The fault plan (faults/), bound once like the planes.
        self._faults = faults.plan()
        weight_bytes = {"int8": 1, "int4": 0.5}.get(self.quant, dtype.itemsize)
        if self._attrib is not None:
            self._attrib.update_component(f"weights:{cfg.name}", int(param_count(cfg) * weight_bytes))
        if self._roofline is not None:
            # The cross-check's modeled range: context 0 to max_seq.
            kv_bytes = 1 if self.kv_quant == "int8" else dtype.itemsize
            for ctx_len in (0, self.max_seq):
                self._roofline.note_modeled(
                    "decode", flops_per_token(cfg, ctx_len),
                    decode_bytes_per_token(cfg, ctx_len, weight_bytes, kv_bytes))
                self._roofline.note_modeled("prefill", flops_per_token(cfg, ctx_len))
        # The KV pool last, once every setting it reads is bound.
        self._kv_pool = pool_for(self)

    # -- helpers ---------------------------------------------------------------

    def to_device(self, values, dtype: torch.dtype = torch.long) -> torch.Tensor:
        """Host values (nested lists) as a tensor on the device (pinned,
        asynchronous copy on a card: no host sync)."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _ids_tensor(self, ids: list[int]) -> torch.Tensor:
        """[1, n] int64 token ids on the device."""
        return self.to_device([ids])

    @property
    def sharded(self) -> bool:
        """True when the engine runs over shards (a mesh of several positions)."""
        return self._groups is not None

    def _shard(self, params: dict) -> list:
        """A whole tree (on the first position's device) as one shard per
        position of this engine's mesh (positions of a ``dp`` axis beyond its
        first index hold none: one stream is one batch row)."""
        from llm_consensus_tpu_torch.parallel.sharding import shard_pytree

        mesh = self.mesh
        keep = [i for i in range(mesh.size) if mesh.coords(i).get("dp", 0) == 0]
        return shard_pytree(params, self._specs, mesh, positions=keep)

    def full_params(self) -> dict:
        """The resident weights as one whole tree: the engine's own on one
        device, or a sharded engine's shards joined on its first device
        (a copy; the handoff's prefill role runs on it)."""
        if self._groups is None:
            return self.params
        from llm_consensus_tpu_torch.parallel.sharding import gather_tree

        return gather_tree(self._shards, self._specs, self.mesh)

    def new_cache(self, batch: int = 1, max_seq: Optional[int] = None):
        """A fresh KV cache of ``batch`` rows and ``max_seq`` slots (default
        the engine's): one ``init_kv_cache`` dict, or a sharded engine's
        list of per-shard caches (one per attention position, its heads)."""
        s = max_seq or self.max_seq
        if self._groups is not None:
            return self._groups[0].new_caches(batch, s, self.dtype, self.kv_quant)
        return init_kv_cache(self.cfg, batch=batch, max_seq=s, device=self.device,
                             dtype=self.dtype, quant=self.kv_quant)

    def _forward(self, tokens, cache, start_pos, *, attn_impl, kv_width=None,
                 logits_index=None, capture=None, **rows):
        """:func:`forward` with this engine's weights and modes; ``rows``
        are the batcher's ``row_start``/``prefix``/``prefix_len``/
        ``prefix_rows``/``kv_mask``; ``capture`` the roofline capture this
        step runs under, if any (it counts the first layer). A sharded
        engine runs :func:`forward_sharded` over its first group (no
        capture)."""
        if self._groups is not None:
            logits = forward_sharded(
                self._groups[0], tokens, cache, start_pos, attn_impl=attn_impl,
                kv_width=kv_width, logits_index=logits_index, mm=self._mm,
                decode_w8a8=self.decode_w8a8, **rows)
            return logits, cache
        return forward(
            self.params, self.cfg, tokens, cache, start_pos=start_pos,
            attn_impl=attn_impl, kv_width=kv_width, logits_index=logits_index,
            layers=self._layers, mm=self._mm, decode_w8a8=self.decode_w8a8,
            layer_scope=capture.layer if capture is not None else None, **rows,
        )

    def _decode_width(self, frontier: int) -> Optional[int]:
        """Attention-width bucket covering ``frontier`` cache slots: a
        multiple of ``DECODE_KV_MIN``, or None (full capacity) once the
        bucket reaches it."""
        b = max(DECODE_KV_MIN, -(-frontier // DECODE_KV_MIN) * DECODE_KV_MIN)
        return None if b >= self.max_seq else b

    # -- prefill ---------------------------------------------------------------

    def _capture(self, family: str, key: tuple, tokens: int, steps: int = 1,
                 kv_valid: Optional[int] = None):
        """Book one dispatch with the roofline ledger: a capture to run the
        dispatch's first step under (passing it to :meth:`_forward`) on the
        key's first sight, else None. The key names this engine's model and
        modes beside the shapes: two models (or one model's bf16 and int8
        engines) share a ledger, and one shape costs each its own work."""
        if self._roofline is None or self._groups is not None:
            return None
        key = (self.cfg.name, str(self.dtype), self.quant, self.kv_quant, self.w8a8,
               self.decode_w8a8, *key)
        return self._roofline.dispatch(family, key, tokens=tokens, steps=steps, kv_valid=kv_valid)

    # -- prefix snapshot ---------------------------------------------------------

    # -- live weight hot-swap ---------------------------------------------------

    def pin_weights(self) -> int:
        """Refcount the resident weights; returns their version. Never
        blocks (the batcher's scheduler pins on its hot path); nesting
        composes."""
        with self._swap_lock:
            self._pins += 1
            return self.weight_version

    def unpin_weights(self) -> None:
        """Release one pin; the LAST unpin applies a pending swap. Extra
        unpins are ignored."""
        flipped = False
        with self._swap_lock:
            if self._pins > 0:
                self._pins -= 1
            if self._pins == 0 and self._pending_swap is not None:
                version, params, meta = self._pending_swap
                self._pending_swap = None
                self._flip_locked(version, params, meta)
                flipped = True
        if flipped:
            self._post_flip()

    def swap_pending(self) -> bool:
        """True while a prepared version waits for the pins to drain, and
        from its flip until the flip's cache hygiene is done (the batcher's
        admission gate: new streams hold so the resident set vacates instead
        of re-pinning the old weights forever, and no admission reads KV
        the old weights left in the prefix snapshot or the KV pool)."""
        with self._swap_lock:
            return self._pending_swap is not None or self._flipping

    def _stale_locked(self, version: int) -> bool:
        return version <= self.weight_version or (
            self._pending_swap is not None and version <= self._pending_swap[0])

    def _prepare_params(self, params: dict):
        """The incoming tree on this engine's device (copies enqueued on
        the current stream), quantized to its resident mode (quantized
        leaves pass through); on a sharded engine then cut into one shard
        per position, as the constructor does, and returned as the shard
        list. The tree is quantized whole before the cut: the row-parallel
        weights' per-column scales span every row, as the JAX engine's
        quantization of its sharded (global) tree gives them."""
        def place(tree: dict) -> dict:
            return {k: place(v) if isinstance(v, dict) else v.to(self.device, non_blocking=True)
                    for k, v in tree.items()}

        params = place(params)
        if self.quant is not None:
            params = quantize_params(params, self.quant)
        return self._shard(params) if self._groups is not None else params

    def _resident(self):
        """The resident weights in the engine's own form: the tree, or a
        sharded engine's shard list (what a flip keeps for rollback)."""
        return self._shards if self._groups is not None else self.params

    def _install(self, weights) -> None:
        """Make ``weights`` (:meth:`_resident`'s form) the resident ones:
        every group's shards flip together. None drops them (a handoff's
        prefill role between waves)."""
        if self._groups is not None:
            self._shards = weights
            for group in self._groups:
                group.install(weights)
        else:
            self.params = weights
            self._layers = layer_views(weights) if weights is not None else None

    def swap_weights(self, version: int, params: dict, *, wait: bool = False,
                     meta: Optional[dict] = None, prepared: bool = False) -> bool:
        """Install ``params`` as weight ``version`` (a monotone int above the
        resident and any pending version; anything else is rejected and
        counted). Preparation runs outside the swap lock under the ``swap``
        attribution tag; the flip is immediate with no pins, else the tree
        parks in the double buffer until the last unpin (``wait=True``
        blocks up to ``swap_wait_s`` for it). Returns True when accepted
        (applied or parked). ``prepared=True`` (the rollback) skips the
        preparation."""
        version = int(version)
        if self._faults is not None:
            fs = self._faults.fire("swap", phase="apply", model=self.cfg.name, version=version)
            if fs is not None and fs.kind == "swap_mid_stream":
                # Hold the apply so live streams are mid-decode when it
                # lands: the pending (double-buffer) path, not an idle flip.
                time.sleep(float(fs.param("s", 0.05)))
        with self._swap_lock:
            if self._stale_locked(version):
                self._swap_stats["swap_rejects"] += 1
                return False
        t_prep = time.monotonic()
        if not prepared:
            with obs.attrib.tag("swap"):
                params = self._prepare_params(params)
        prep_ms = (time.monotonic() - t_prep) * 1000.0
        flipped = False
        with self._swap_lock:
            if self._stale_locked(version):
                # Lost a race to a concurrent swap while preparing.
                self._swap_stats["swap_rejects"] += 1
                return False
            self._swap_stats["last_prep_ms"] = prep_ms
            self._swap_requested = time.monotonic()
            if self._pins == 0:
                self._flip_locked(version, params, meta)
                flipped = True
            else:
                self._pending_swap = (version, params, meta)
                self._swap_stats["swap_queued"] += 1
                if wait:
                    deadline = time.monotonic() + self.swap_wait_s
                    while self.weight_version < version:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._swap_cv.wait(timeout=remaining)
        if flipped:
            self._post_flip()
        return True

    def rollback_weights(self, meta: Optional[dict] = None) -> Optional[int]:
        """Swap back to the previous resident weights under a NEW version
        (versions never reappear); returns it, or None when there is
        nothing to roll back to."""
        with self._swap_lock:
            if self._prev_weights is None:
                return None
            prev_version, prev_params = self._prev_weights
            new_version = self.weight_version + 1
            from_version = self.weight_version
        m = dict(meta or {})
        m.setdefault("rolled_back_to", prev_version)
        m.setdefault("rolled_back_from", from_version)
        if not self.swap_weights(new_version, prev_params, prepared=True, meta=m):
            return None
        with self._swap_lock:
            self._swap_stats["rollbacks"] += 1
        return new_version

    def _flip_locked(self, version: int, params: dict, meta: Optional[dict]) -> None:
        """The buffer flip; the caller holds ``_swap_lock`` and no stream
        holds a pin, so no queued kernel reads the replaced tree after it
        (the tree it replaces as ``_prev_weights`` is freed here, when its
        last reference goes)."""
        self._prev_weights = (self.weight_version, self._resident())
        self._install(params)
        self.weight_version = version
        self.weight_meta = dict(meta or {})
        self._flipping = True
        vacate_ms = max(0.0, (time.monotonic() - self._swap_requested) * 1000.0)
        self._swap_stats["swaps"] += 1
        self._swap_stats["last_vacate_ms"] = vacate_ms
        self._swap_cv.notify_all()
        lm = obs.live.metrics()
        if lm is not None:
            lm.observe("swap_vacate", vacate_ms / 1000.0, model=self.cfg.name,
                       version=str(version))

    def _post_flip(self) -> None:
        """Cache hygiene after a flip, outside the swap lock: every cached
        KV byte came from the old weights, so the prefix snapshot drops and
        the KV pool evicts every cold block (no stream is resident at a
        flip, so no lease holds one). The admission gate opens again even
        when the hygiene raises: the error reaches the swap's caller, and a
        gate left shut would hold every later stream for good."""
        try:
            self.drop_prefix()
            if self._kv_pool is not None:
                self._kv_pool.evict_cold(0.0)
        finally:
            with self._swap_lock:
                self._flipping = False

    def swap_stats(self) -> dict:
        """Swap counters and the live pin state (the JAX keys)."""
        with self._swap_lock:
            out = dict(self._swap_stats)
            out["weight_version"] = self.weight_version
            out["pins"] = self._pins
            out["swap_pending"] = 1 if self._pending_swap is not None else 0
            return out

    def _reusable_prefix(self, prompt_ids: list[int]) -> tuple[int, Optional[dict]]:
        """``(common-prefix length, snapshot cache)`` against the snapshot,
        read as a pair so a concurrent generate cannot hand out a cache
        that does not match the ids compared. The length is capped at
        ``len(prompt_ids) - 1``: at least one token must prefill to give
        the next-token logits. Under the KV pool: a radix match and a block
        gather into a private cache, a miss below one prefill chunk."""
        if not self.prefix_cache_enabled:
            return 0, None
        if self._kv_pool is not None:
            return self._kv_pool.lookup(prompt_ids, min_tokens=self.prefill_chunk or 1)
        with self._prefix_lock:
            saved_ids, saved_cache = self._prefix_ids, self._prefix_cache
        if saved_ids is None:
            return 0, None
        max_l = min(len(saved_ids), len(prompt_ids) - 1)
        lcp = next((i for i, (a, b) in enumerate(zip(saved_ids[:max_l], prompt_ids[:max_l]))
                    if a != b), max_l)
        return (lcp, saved_cache) if lcp > 0 else (0, None)

    def _retain_prefix(self, ids: list[int], cache: dict) -> bool:
        """Keep a finished cache as the snapshot of ``ids``: its positions
        ``[0, len(ids))`` must hold exactly their KV, and nothing may write
        it afterwards (restores copy it). Costs residency only. Under the
        KV pool the cache's blocks are published instead (only those the
        radix lacks); returns True when that publish was truncated."""
        if not self.prefix_cache_enabled:
            return False
        if self._kv_pool is not None:
            _wrote, truncated = self._kv_pool.publish(ids, cache)
            return truncated
        with self._prefix_lock:
            self._prefix_ids = tuple(ids)
            self._prefix_cache = cache
        return False

    def drop_prefix(self) -> None:
        """Forget the snapshot (its memory becomes collectible)."""
        with self._prefix_lock:
            self._prefix_ids = None
            self._prefix_cache = None

    def close_sessions(self) -> None:
        """Close every open :class:`PrefillSession` of this engine, dropping
        their caches; a closed session refuses appends and ``generate``."""
        for session in list(self._sessions):
            session.close()

    # -- prefill ---------------------------------------------------------------

    def _prefill_chunk(self, tokens: torch.Tensor, cache: dict, start: int,
                       last_index: torch.Tensor, kv_width: int, capture=None) -> torch.Tensor:
        """One fixed-size prefill chunk at ``start`` over the first
        ``kv_width`` cache slots (the plain attention op, as the JAX package
        runs XLA here). Returns the logits at ``last_index`` [1, V]."""
        logits, _ = self._forward(tokens, cache, start, attn_impl="torch", kv_width=kv_width,
                                  logits_index=last_index, capture=capture)
        return logits[:, 0]

    def _chunked_prefill(self, prompt_ids: list[int], cache: dict, chunk: int, base: int = 0):
        """Prefill ``prompt_ids[base:]`` in fixed chunks at a running start
        over the bucket of the chunks' end; ``base`` > 0 resumes on top of
        a restored prefix. Chunks start at ``base + i * chunk``, not at
        multiples of the chunk."""
        tail = len(prompt_ids) - base
        n_tail = -(-tail // chunk)
        padded = prompt_ids[base:] + [0] * (n_tail * chunk - tail)
        kv_width = _bucket(base + n_tail * chunk, self.max_seq)
        last_in_chunk = torch.full((1,), (tail - 1) % chunk, device=self.device)
        tokens = self._ids_tensor(padded)
        # One prefill dispatch of n_tail steps, the JAX chunk loop's count.
        cap = self._capture("prefill", ((1, chunk), kv_width), n_tail * chunk, n_tail)
        for i in range(n_tail):
            counted = cap if i == 0 else None
            with counted or nullcontext():
                last_logits = self._prefill_chunk(
                    tokens[:, i * chunk:(i + 1) * chunk], cache, base + i * chunk,
                    last_in_chunk, kv_width, capture=counted)
        return last_logits, cache

    def _prefill_ids(self, prompt_ids: list[int]):
        """Prefill ``prompt_ids`` into a fresh or prefix-restored cache;
        returns ``(last_logits [1, V] fp32, cache)``. A prompt sharing at
        least one chunk with the snapshot (or the KV pool) restores that
        prefix and prefills only its tail; otherwise one shot (flash) or
        chunked from 0."""
        if self._faults is not None:
            self._faults.check("prefill")  # injected device OOM / loss
        t0_obs = self._obs.now() if self._obs is not None else 0
        n_prompt = len(prompt_ids)
        chunk_len = self.prefill_chunk
        n_chunks = -(-n_prompt // chunk_len) if chunk_len else 1
        reuse_len, saved = self._reusable_prefix(prompt_ids)
        n_tail = -(-(n_prompt - reuse_len) // chunk_len) if chunk_len else 0
        reuse_ok = (chunk_len > 0 and reuse_len >= chunk_len
                    and reuse_len + n_tail * chunk_len <= self.max_seq)
        if reuse_ok:
            restore = _restore_prefix_owned if self._kv_pool is not None else _restore_prefix
            cache = restore(saved, reuse_len)
            last_logits, cache = self._chunked_prefill(prompt_ids, cache, chunk_len, reuse_len)
        else:
            cache = self.new_cache()
            sp = len(self._groups) if self._groups is not None else 1
            sp_bucket = _bucket(max(n_prompt, sp), self.max_seq) if sp > 1 else 0
            if sp > 1 and sp_bucket % sp == 0:
                # Sequence-parallel prefill: the prompt's bucket splits over
                # the sp positions (ring attention); a bucket clamped to a
                # max_seq it does not divide takes the paths below.
                tokens = self._ids_tensor(prompt_ids + [0] * (sp_bucket - n_prompt))
                last = torch.full((1,), n_prompt - 1, device=self.device)
                logits = forward_ring_prefill(self._groups, tokens, cache, last, mm=self._mm)
                last_logits = logits[:, 0]
            elif chunk_len and n_prompt > chunk_len and n_chunks * chunk_len <= self.max_seq:
                last_logits, cache = self._chunked_prefill(prompt_ids, cache, chunk_len)
            else:
                bucket = _bucket(n_prompt, self.max_seq)
                tokens = self._ids_tensor(prompt_ids + [0] * (bucket - n_prompt))
                last = torch.full((1,), n_prompt - 1, device=self.device)
                cap = self._capture("prefill", (1, bucket), bucket)
                with cap or nullcontext():
                    logits, cache = self._forward(
                        tokens, cache, 0, attn_impl="flash", logits_index=last, capture=cap,
                    )
                last_logits = logits[:, 0]
        if self._obs is not None:
            self._obs.complete("prefill", t0_obs, tid="engine", tokens=n_prompt,
                               reused=reuse_len if reuse_ok else 0)
        return last_logits, cache

    def _rows_bucket(self, n_max: int) -> int:
        """Cache capacity :class:`AdmissionPrefill` allocates for a
        full-prompt wave whose longest prompt is ``n_max``: the batcher's
        admission width check must agree with it exactly (it splices rows
        of this width)."""
        bucket = _bucket(n_max, self.max_seq)
        chunk_len = self.prefill_chunk
        if (
            chunk_len
            and bucket > chunk_len
            and -(-bucket // chunk_len) * chunk_len <= self.max_seq
        ):
            bucket = -(-bucket // chunk_len) * chunk_len
        return bucket

    def prefill_session(self) -> "PrefillSession":
        """An incremental prefill session: token chunks append to one
        growing KV cache as they become known (the judge-overlap path)."""
        session = PrefillSession(self)
        self._sessions.add(session)
        return session

    def admission_session(self, rows: list[list[int]], prefix_cache=None,
                          prefix_len: int = 0) -> "AdmissionPrefill":
        """A resumable batched admission prefill over ``rows`` (suffixes
        against ``prefix_cache`` when given): the one-shot wrappers below
        drive it with ``step(None)``; the batcher's interleaved admission
        paces ``step`` with a token budget between decode chunks."""
        return AdmissionPrefill(self, rows, prefix_cache, prefix_len)

    def _prefill_rows(self, rows: list[list[int]]):
        """Batched admission prefill: k left-aligned prompts in one pass,
        padded to a shared bucket. Returns ``(last_logits [k, V], cache,
        width)``; the cache's capacity is the bucket ``width`` (the batcher
        copies rows out)."""
        return AdmissionPrefill(self, rows).run()

    def _prefill_rows_suffix(self, rows_sfx: list[list[int]], prefix_cache, plen: int):
        """Batched suffix prefill against a shared-prefix KV: each suffix
        token attends the prefix (the exact two-source merge) plus its own
        causal window, at positions offset by ``plen``. Returns
        ``(last_logits [k, V], cache [k, width], width)``, the cache holding
        suffix KV only."""
        return AdmissionPrefill(self, rows_sfx, prefix_cache, plen).run()

    # -- decode ------------------------------------------------------------------

    def _decode_chunk(self, token: torch.Tensor, pos: torch.Tensor, cache: dict,
                      n_steps: int, gen: Optional[torch.Generator], sample_args: tuple,
                      kv_width: Optional[int], kv_valid: Optional[int] = None, *,
                      sentinel: bool = False, poison_row: Optional[int] = None, **rows):
        """``n_steps`` one-token steps over every row of ``cache``, sampling
        on the device. ``token`` [B] is each row's last token and ``pos``
        the int32 device scalar of the shared write slot; ``rows`` as
        :meth:`_forward`; ``kv_valid`` the host-known valid cache slots of
        the first step summed over rows (the roofline's count of the decode
        kernel's work). Returns ``(last token [B], tokens [n_steps, B],
        pos + n_steps)``.

        ``sentinel=True`` adds the integrity plane's finite-logit sentinel:
        per step ``isfinite(last).all(-1)`` AND-folded into a [B] bool
        verdict, returned as a fourth output (the batcher copies it beside
        the tokens, so it rides the chunk's one fetch). ``poison_row`` (the
        ``nan_logits`` fault) sets that row's last logits to NaN before
        sampling. With ``sentinel=False`` the step is unchanged: no launch,
        no allocation."""
        cap = self._capture("decode", (tuple(token.shape), n_steps, kv_width),
                            n_steps * token.shape[0], n_steps, kv_valid)
        ok = torch.ones(token.shape[0], dtype=torch.bool, device=token.device) if sentinel else None

        def step(token, pos, capture=None):
            logits, _ = self._forward(
                token[:, None], cache, pos, attn_impl="flash", kv_width=kv_width,
                capture=capture, **rows,
            )
            last = logits[:, -1]
            if poison_row is not None:
                last[poison_row] = float("nan")
            if sentinel:
                ok.logical_and_(torch.isfinite(last).all(-1))
            return sample_token(last, gen, *sample_args)

        toks = []
        for i in range(n_steps):
            if i == 0 and cap is not None:
                with cap:  # one step counted: the key's work per step
                    token = step(token, pos, cap)
            else:
                token = step(token, pos)
            toks.append(token)
            pos = pos + 1
        if sentinel:
            return token, torch.stack(toks), pos, ok
        return token, torch.stack(toks), pos

    # -- token-level API -------------------------------------------------------

    def generate_ids(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams = SamplingParams(),
        ctx: Optional[Context] = None,
        on_token: Optional[Callable[[int], None]] = None,
    ) -> GenerateResult:
        # Pinned for the whole generation: a swap landing mid-stream parks
        # until this (and every other pinned) stream ends.
        self.pin_weights()
        try:
            return self._generate_ids_pinned(prompt_ids, sampling, ctx, on_token)
        finally:
            self.unpin_weights()

    def _generate_ids_pinned(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams,
        ctx: Optional[Context],
        on_token: Optional[Callable[[int], None]],
    ) -> GenerateResult:
        ctx = ctx or Context.background()
        start_time = time.monotonic()
        n_prompt = len(prompt_ids)
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt >= self.max_seq:
            raise ValueError(
                f"prompt length {n_prompt} exceeds max sequence length {self.max_seq}"
            )
        max_new = min(sampling.max_new_tokens, self.max_seq - n_prompt)
        if max_new <= 0:
            return GenerateResult(
                token_ids=[], text="", finish_reason="length", prompt_tokens=n_prompt,
                latency_ms=(time.monotonic() - start_time) * 1000,
            )
        with torch.inference_mode():
            wall = DeviceWall(self.device) if self._attrib is not None else None
            with obs.attrib.tag("prefill"):
                last_logits, cache = self._prefill_ids(prompt_ids)
            return self._decode_stream(
                prompt_ids, last_logits, cache, sampling, ctx, on_token, start_time,
                prefill_wall=wall.stop() if wall is not None else None,
            )

    def _decode_stream(
        self,
        prompt_ids: list[int],
        last_logits: torch.Tensor,
        cache: dict,
        sampling: SamplingParams,
        ctx: Context,
        on_token: Optional[Callable[[int], None]],
        start_time: float,
        prefill_wall: Optional[DeviceWall] = None,
    ) -> GenerateResult:
        """The streamed decode loop over an established cache;
        ``prefill_wall`` is booked at the first fetch."""
        n_prompt = len(prompt_ids)
        max_new = min(sampling.max_new_tokens, self.max_seq - n_prompt)
        gen = torch.Generator(device=self.device).manual_seed(sampling.seed)
        sample_args = (sampling.temperature, sampling.top_k, sampling.top_p)
        token = sample_token(last_logits, gen, *sample_args)  # [1], on device
        first: Optional[torch.Tensor] = token  # rides down with the first fetch
        pos_dev = torch.full((), n_prompt, dtype=torch.int32, device=self.device)

        eos = -1 if sampling.ignore_eos else self.tokenizer.eos_id
        out_ids: list[int] = []
        finish = "length"
        pos = n_prompt  # host mirror of pos_dev: slots dispatched so far
        chunk = self.stream_interval

        def emit(tok_ids) -> bool:
            """Accept fetched token ids; True if generation should stop."""
            nonlocal finish
            for tok_id in tok_ids:
                if tok_id == eos:
                    finish = "eos"
                    return True
                if len(out_ids) >= max_new:
                    return True
                out_ids.append(tok_id)
                if on_token is not None:
                    on_token(tok_id)
            return False

        # Telemetry, bound at construction: per chunk one check at dispatch
        # and one at fetch when every plane is off.
        obs_r, attrib = self._obs, self._attrib

        stopped = False
        # Decode-rate clock: starts at the first fetch boundary (prefill +
        # chunk 1 complete), so it measures steady-state decode only.
        t_first_fetch: Optional[float] = None
        n_at_first_fetch = 0
        t_last_fetch = 0.0
        n_at_last_fetch = 0

        def fetch(pending: _Fetch) -> None:
            nonlocal stopped, t_first_fetch, n_at_first_fetch, t_last_fetch, n_at_last_fetch
            nonlocal prefill_wall
            t0_obs = obs_r.now() if obs_r is not None else 0
            n_before = len(out_ids)
            fetched = pending.ids()
            stopped = emit(fetched)
            if obs_r is not None:
                obs_r.complete("fetch", t0_obs, tid="engine", tokens=len(fetched))
            if attrib is not None:
                # The chunk's copy is done, so its interval, and the
                # prefill's before it, can be read without a wait.
                if prefill_wall is not None:
                    attrib.observe_device("prefill", prefill_wall.seconds())
                    prefill_wall = None
                attrib.observe_device("decode", pending.wall.seconds())
                attrib.token_event("useful", len(out_ids) - n_before)
            now = time.monotonic()
            if t_first_fetch is None:
                t_first_fetch, n_at_first_fetch = now, len(out_ids)
            else:
                t_last_fetch, n_at_last_fetch = now, len(out_ids)

        inflight: Optional[_Fetch] = None
        inflight_n = 0
        while not stopped:
            pending_n = inflight_n + (1 if first is not None else 0)
            if max_new - len(out_ids) - pending_n <= 0:
                break  # everything needed is dispatched; drain below
            # Cancellation only aborts outstanding work: a deadline landing
            # while the final tokens drain must not fail a complete result.
            if ctx.done():
                finish = "deadline" if ctx.remaining() == 0.0 else "cancelled"
                stopped = True
                break
            dispatched = None
            n_steps = 0
            inflight_first = 0  # the prefill-sampled token rides this chunk
            if pos < self.max_seq:
                if self._faults is not None:
                    self._faults.check("decode")  # injected device loss
                    if self.weight_version > 0:
                        # canary_regress: a swapped-in engine's decode
                        # slows by @s a chunk (the regression a canary
                        # must catch).
                        fs = self._faults.fire("swap", phase="decode", model=self.cfg.name,
                                               version=self.weight_version)
                        if fs is not None and fs.kind == "canary_regress":
                            time.sleep(float(fs.param("s", 0.05)))
                n_steps = chunk if pos + chunk <= self.max_seq else 1
                t0_obs = obs_r.now() if obs_r is not None else 0
                wall = DeviceWall(self.device) if attrib is not None else None
                token, toks, pos_dev = self._decode_chunk(
                    token, pos_dev, cache, n_steps, gen, sample_args,
                    self._decode_width(pos + n_steps),
                    kv_valid=min(pos + 1, self.cfg.sliding_window or pos + 1),
                )
                ids = toks[:, 0]
                if first is not None:
                    ids = torch.cat([first, ids])
                    first = None
                    inflight_first = 1
                dispatched = _Fetch(ids, wall)
                if obs_r is not None:
                    # Host dispatch wall (the enqueue; device time is the
                    # attribution ledger's).
                    obs_r.complete("decode", t0_obs, tid="engine", steps=n_steps)
                pos += n_steps
            if inflight is not None:
                fetch(inflight)  # overlaps the chunk just enqueued
            elif dispatched is None:
                break  # nothing running and nothing left to dispatch
            inflight = dispatched
            inflight_n = n_steps + inflight_first
        if not stopped and inflight is not None:
            fetch(inflight)
        if not stopped and first is not None and len(out_ids) < max_new:
            n_before = len(out_ids)
            emit([int(first.item())])
            if attrib is not None:
                attrib.token_event("useful", len(out_ids) - n_before)
        if attrib is not None and prefill_wall is not None and prefill_wall.done():
            attrib.observe_device("prefill", prefill_wall.seconds())

        # Retain the finished cache for prefix reuse, with the ids whose KV
        # it holds: the decode steps wrote slots [0, pos), the prompt and
        # every token fed back. That is all emitted ids except, when the
        # loop stopped at max_new with no step left to feed it, the last
        # one; slots past len(ids), such as the overshoot after EOS, are
        # zeroed on restore. Under the KV pool this is the publish (a partial
        # tail block is published too, so it must not claim that last id).
        kv_truncated = self._retain_prefix((prompt_ids + out_ids)[:pos], cache)

        decode_tokens, decode_s = 0, 0.0
        if t_first_fetch is not None and t_last_fetch > t_first_fetch:
            decode_tokens = n_at_last_fetch - n_at_first_fetch
            decode_s = t_last_fetch - t_first_fetch
        return GenerateResult(
            token_ids=out_ids,
            text=self.tokenizer.decode(out_ids),
            finish_reason=finish,
            prompt_tokens=n_prompt,
            latency_ms=(time.monotonic() - start_time) * 1000,
            decode_tokens=decode_tokens,
            decode_s=decode_s,
            kv_truncated=kv_truncated,
        )

    # -- batched API -------------------------------------------------------------

    def generate_batch(
        self,
        prompts: list[str],
        sampling: SamplingParams = SamplingParams(),
        ctx: Optional[Context] = None,
    ) -> list[GenerateResult]:
        """Decode ``len(prompts)`` streams in one static batch (the JAX
        engine's serving-throughput API). Rows are right-aligned (left-padded)
        to one bucket with per-row ``row_start`` offsets; finished rows keep
        stepping (their output is dropped) until every row finishes. The
        whole batch is pinned to one weight version. The batch prefill runs
        the plain attention op, as the JAX engine sends it to XLA; every
        decode step launches the decode kernel with the row starts."""
        self.pin_weights()
        try:
            with torch.inference_mode():
                return self._generate_batch_pinned(prompts, sampling, ctx)
        finally:
            self.unpin_weights()

    def _generate_batch_pinned(
        self,
        prompts: list[str],
        sampling: SamplingParams,
        ctx: Optional[Context],
    ) -> list[GenerateResult]:
        ctx = ctx or Context.background()
        start_time = time.monotonic()
        if not prompts:
            return []
        rows: list[list[int]] = []
        truncated: list[bool] = []
        for p in prompts:
            ids, trunc = self._budget_prompt(self.tokenizer.encode(p), sampling.max_new_tokens)
            if not ids:
                raise ValueError("empty prompt")
            rows.append(ids)
            truncated.append(trunc)
        n_max = max(len(r) for r in rows)
        if n_max >= self.max_seq:
            raise ValueError(f"prompt length {n_max} exceeds max sequence length {self.max_seq}")
        b = len(rows)
        bucket = _bucket(n_max, self.max_seq)
        if bucket >= self.max_seq:
            # Decode slots start at the shared bucket: one that rounds up to
            # max_seq would leave no room, so the rows fit exactly.
            bucket = n_max
        # Long buckets prefill in chunks like the single-stream path, the
        # rows right-aligned to a chunk multiple.
        chunk_len = self.prefill_chunk
        use_chunks = bool(chunk_len) and bucket > chunk_len
        if use_chunks:
            pad_to = -(-bucket // chunk_len) * chunk_len
            if pad_to >= self.max_seq:
                use_chunks = False
            else:
                bucket = pad_to
        max_new = min(sampling.max_new_tokens, self.max_seq - bucket)
        row_start_list = [bucket - len(r) for r in rows]
        row_start = self.to_device(row_start_list, torch.int32)
        tokens = self.to_device([[0] * s + r for s, r in zip(row_start_list, rows)])
        cache = self.new_cache(b)
        step = chunk_len if use_chunks else bucket
        last = torch.full((b,), (bucket - 1) % step, device=self.device)
        with obs.attrib.tag("prefill"):
            for i in range(bucket // step):
                logits, _ = self._forward(
                    tokens[:, i * step:(i + 1) * step], cache, i * step, attn_impl="torch",
                    kv_width=bucket, logits_index=last, row_start=row_start)
        gen = torch.Generator(device=self.device).manual_seed(sampling.seed)
        sample_args = (sampling.temperature, sampling.top_k, sampling.top_p)
        token = sample_token(logits[:, 0], gen, *sample_args)  # [B]
        pos_dev = torch.full((), bucket, dtype=torch.int32, device=self.device)

        eos = -1 if sampling.ignore_eos else self.tokenizer.eos_id
        out_ids: list[list[int]] = [[] for _ in range(b)]
        finish = ["length"] * b
        done = [max_new <= 0] * b
        pos = bucket
        chunk = self.stream_interval
        window = self.cfg.sliding_window

        def emit(step_tokens) -> None:
            for i in range(b):
                if done[i]:
                    continue
                tok = int(step_tokens[i])
                if tok == eos:
                    finish[i] = "eos"
                    done[i] = True
                    continue
                out_ids[i].append(tok)
                if len(out_ids[i]) >= max_new:
                    done[i] = True

        # One-chunk lookahead like the single-stream loop: chunk N+1 is
        # dispatched before chunk N's tokens are fetched; overshoot past EOS
        # or max_new is dropped by emit.
        first = token if max_new > 0 else None
        inflight: Optional[_Fetch] = None
        steps_needed = max_new - 1  # tokens beyond the prefill-sampled one
        steps_dispatched = 0
        while not all(done):
            if ctx.done():
                reason = "deadline" if ctx.remaining() == 0.0 else "cancelled"
                for i in range(b):
                    if not done[i]:
                        finish[i] = reason
                break
            dispatched = None
            if steps_dispatched < steps_needed and pos < self.max_seq:
                n_steps = chunk if pos + chunk <= self.max_seq else 1
                kv_valid = sum(min(pos + 1 - s, window or pos + 1) for s in row_start_list)
                token, toks, pos_dev = self._decode_chunk(
                    token, pos_dev, cache, n_steps, gen, sample_args,
                    self._decode_width(pos + n_steps), kv_valid=kv_valid, row_start=row_start)
                if first is not None:
                    toks = torch.cat([first[None], toks])
                    first = None
                dispatched = _Fetch(toks)
                steps_dispatched += n_steps
                pos += n_steps
            if inflight is not None:
                for step_tokens in inflight.values():
                    emit(step_tokens)
            elif dispatched is None:
                break
            inflight = dispatched
        # Only the prefill-sampled token can still be pending, when
        # max_new == 1 dispatched no chunk at all.
        if not all(done) and first is not None and not ctx.done():
            emit(first.tolist())
        return [
            GenerateResult(
                token_ids=out_ids[i],
                text=self.tokenizer.decode(out_ids[i]),
                finish_reason=finish[i],
                prompt_tokens=len(rows[i]),
                latency_ms=(time.monotonic() - start_time) * 1000,
                truncated_prompt=truncated[i],
            )
            for i in range(b)
        ]

    # -- text-level API --------------------------------------------------------

    def _prompt_budget(self, max_new: int) -> int:
        """Prompt tokens the context window affords next to a ``max_new``
        decode reserve (at least half the window)."""
        budget = self.max_seq - 1 - min(max_new, max(16, self.max_seq // 4))
        return max(budget, self.max_seq // 2, 1)

    def _budget_prompt(self, prompt_ids: list[int], max_new: int) -> tuple[list[int], bool]:
        """Middle-out truncation when the prompt exceeds the context budget:
        keep the head (instructions) and the tail (latest answers and the
        closing directive)."""
        budget = self._prompt_budget(max_new)
        if len(prompt_ids) <= budget:
            return prompt_ids, False
        head = budget // 2
        tail = budget - head
        return prompt_ids[:head] + prompt_ids[-tail:], True

    def generate(
        self,
        prompt: str,
        sampling: SamplingParams = SamplingParams(),
        ctx: Optional[Context] = None,
        on_text: Optional[Callable[[str], None]] = None,
    ) -> GenerateResult:
        prompt_ids = self.tokenizer.encode(prompt)
        prompt_ids, truncated = self._budget_prompt(prompt_ids, sampling.max_new_tokens)
        decoder = StreamDecoder(self.tokenizer)
        parts: list[str] = []

        def on_token(tok_id: int) -> None:
            text = decoder.push(tok_id)
            if text:
                parts.append(text)
                if on_text is not None:
                    on_text(text)

        result = self.generate_ids(prompt_ids, sampling, ctx, on_token)
        tail = decoder.flush()
        if tail:
            parts.append(tail)
            if on_text is not None:
                on_text(tail)
        result.text = "".join(parts)
        result.truncated_prompt = truncated
        return result



class AdmissionPrefill:
    """One admission wave of k rows prefilled in one pass, resumable (the JAX
    engine's ``AdmissionPrefill``).

    Full-prompt rows are left-aligned and padded to ``_rows_bucket``: a
    bucket within ``prefill_chunk`` runs one-shot from position 0 through
    the flash kernel at B = k; a longer one runs in fixed chunks at a
    running start through the plain attention op. With ``prefix_cache``
    the rows are suffixes prefilled against the pool's shared prefix
    (positions offset by ``prefix_len``, the plain op with the prefix
    merge), padded to their own power-of-two bucket, and the cache holds
    only suffix KV.

    ``step(token_budget)`` dispatches chunks until ``token_budget`` total
    prompt tokens (rows x chunk) went out in this call, at least one chunk,
    so the continuous batcher can pace a wave between its decode chunks
    (interleaved admission); ``step(None)`` runs to completion, the classic
    path. A one-shot wave is one indivisible step. ``finish()`` then gives
    ``(last_logits [k, V], cache [k, width], width)``. Pacing changes when
    the chunks run, never what they compute.

    A chunked full-prompt wave whose rows share at least one whole chunk
    with the engine's prefix snapshot (or hold it in the KV pool) forks it
    across the k rows (at construction) and prefills only the chunks after
    it; a chunked wave of 2+ rows that share a chunk among themselves
    retains its row 0 as the next snapshot (at ``finish``). Under the pool
    a lone-row wave retains too (a publish evicts nobody), unless the radix
    already covers row 0's whole blocks.
    """

    def __init__(self, engine: Engine, rows: list[list[int]], prefix_cache=None,
                 prefix_len: int = 0):
        if engine._faults is not None:
            engine._faults.check("prefill")  # injected device OOM / loss
        self._eng = engine
        self._t0_obs = engine._obs.now() if engine._obs is not None else 0
        self.rows = rows
        self.k = len(rows)
        self._prefix_cache = prefix_cache
        self._plen = prefix_len
        n_max = max(len(r) for r in rows)
        self._chunk_len = chunk = engine.prefill_chunk
        if prefix_cache is not None:
            self.width = _bucket(n_max, engine.max_seq)
        else:
            self.width = engine._rows_bucket(n_max)
        width = self.width
        # A bucket capped at a max_seq that is no chunk multiple cannot
        # chunk (flooring would drop the tail) and runs one-shot instead.
        self._use_chunks = bool(chunk) and width > chunk and width % chunk == 0
        # Wave prefix reuse (the panel's one-prompt fan-out): whole chunks
        # of the rows' common prefix found in the snapshot are forked, not
        # prefilled. Full-prompt chunked waves only.
        reuse_base, saved = 0, None
        self._common: list[int] = []
        if prefix_cache is None and self._use_chunks and engine.prefix_cache_enabled:
            self._common = self._common_prefix()
            lcp, snap = (engine._reusable_prefix(self._common) if self._common
                         else (0, None))
            base = lcp // chunk * chunk
            if base >= chunk:
                reuse_base, saved = base, snap
        if saved is not None:
            self._cache = _fork_prefix(saved, reuse_base, self.k, width)
        else:
            self._cache = engine.new_cache(self.k, width)
        self._tokens = engine.to_device([r + [0] * (width - len(r)) for r in rows])
        self._n_chunks = width // chunk if self._use_chunks else 1
        self._first = reuse_base // chunk if self._use_chunks else 0
        self._next = self._first
        self._per_chunk: list[torch.Tensor] = []
        self._last_logits: Optional[torch.Tensor] = None
        self._cap = None
        self._done = False

    @property
    def remaining_tokens(self) -> int:
        """Total prompt tokens (rows x chunk) not dispatched yet: the
        batcher's pacing is sized off this."""
        if self._done:
            return 0
        if not self._use_chunks:
            return self.k * self.width
        return self.k * self._chunk_len * (self._n_chunks - self._next)

    def _common_prefix(self) -> list[int]:
        common = self.rows[0]
        for r in self.rows[1:]:
            m = min(len(common), len(r))
            i = 0
            while i < m and common[i] == r[i]:
                i += 1
            common = common[:i]
        return common

    def step(self, token_budget: Optional[int]) -> bool:
        """Dispatch prefill chunks until ``token_budget`` total prompt tokens
        (rows x chunk) went out in this call, at least one chunk; ``None``
        runs to completion. True once every dispatch of the wave is made
        (``finish`` may then be called)."""
        if self._done:
            return True
        eng, width = self._eng, self.width
        prefix = {}
        if self._prefix_cache is not None:
            prefix = {"prefix": self._prefix_cache, "prefix_len": self._plen}
        if not self._use_chunks:
            last = eng.to_device([len(r) - 1 for r in self.rows])
            # The flash kernel serves full-prompt waves; suffix waves take
            # the plain op (the prefill kernel has no merge-state form).
            impl = "torch" if prefix else "flash"
            cap = eng._capture("prefill", (self.k, width), self.k * width)
            with cap or nullcontext():
                logits, self._cache = eng._forward(self._tokens, self._cache, 0, attn_impl=impl,
                                                   logits_index=last, capture=cap, **prefix)
            self._last_logits = logits[:, 0]
            self._done = True
            return True
        chunk = self._chunk_len
        if self._next == self._first:
            # One prefill dispatch of the wave's chunks for the roofline
            # (the JAX chunk loop's count), its first chunk counted.
            self._cap = eng._capture("prefill", ((self.k, chunk), width),
                                     self.k * (width - self._first * chunk),
                                     self._n_chunks - self._first)
        spent = 0
        while self._next < self._n_chunks:
            c = self._next
            # Per-row "last token in THIS chunk", clamped: each row reads
            # the logits of the chunk that holds its real last token.
            idx = eng.to_device([min(max(len(r) - 1 - c * chunk, 0), chunk - 1)
                                 for r in self.rows])
            counted = self._cap if c == self._first else None
            with counted or nullcontext():
                logits, self._cache = eng._forward(
                    self._tokens[:, c * chunk:(c + 1) * chunk], self._cache, c * chunk,
                    attn_impl="torch", kv_width=width, logits_index=idx, capture=counted,
                    **prefix,
                )
            self._per_chunk.append(logits[:, 0])
            self._next += 1
            spent += self.k * chunk
            if token_budget is not None and spent >= token_budget:
                break
        self._done = self._next >= self._n_chunks
        return self._done

    def finish(self):
        """``(last_logits [k, V], cache [k, width], width)`` once ``step``
        returned True: each row's real last-token logits, the wave's row 0
        retained as the snapshot when the rows share a chunk, an
        ``admit_prefill`` span."""
        if not self._done:
            raise RuntimeError("admission prefill finished before its last step")
        eng, width, chunk = self._eng, self.width, self._chunk_len
        cache = self._cache
        if not self._use_chunks:
            last_logits = self._last_logits
        else:
            sel = eng.to_device([(len(r) - 1) // chunk - self._first for r in self.rows])
            stacked = torch.stack(self._per_chunk)  # [C - first, k, V]
            last_logits = stacked[sel, torch.arange(self.k, device=stacked.device)]
            # Row 0 becomes the next snapshot when the wave's rows share a
            # chunk (evidence of prefix traffic; a wave of unrelated
            # prompts must not evict a live snapshot) and the snapshot is
            # not already row 0: the copy allocates a full [1, max_seq]
            # cache. Under the KV pool a lone row retains too (a publish
            # evicts nobody), and the staleness check is the radix's
            # whole-block cover, last: it takes the pool's lock.
            pool = eng._kv_pool
            if (
                (self.k > 1 or pool is not None) and len(self._common) >= chunk
                and (not pool.covers(self.rows[0]) if pool is not None
                     else eng._prefix_ids != tuple(self.rows[0]))
            ):
                template = eng.new_cache(1)
                eng._retain_prefix(self.rows[0], _extract_row0(template, cache, width))
        if eng._obs is not None:
            args = {"rows": self.k, "width": width}
            if self._prefix_cache is not None:
                args["prefix"] = self._plen
            eng._obs.complete("admit_prefill", self._t0_obs, tid="engine", **args)
        return last_logits, cache, width

    def run(self):
        """The classic one-shot drive: ``step(None)``, then ``finish()``."""
        self.step(None)
        return self.finish()


class PrefillSession:
    """Incremental prefill: token chunks append to ONE growing KV cache (the
    JAX engine's ``PrefillSession``, the judge-overlap half of its
    prefill/decode overlap, consensus/overlap.py).

    The judge prompt's header and each panel answer prefill the moment they
    exist, through the engine's own chunk forward (:meth:`Engine._prefill_chunk`),
    instead of after the last answer lands. Each whole chunk dispatches as
    soon as it is complete, over ``kv_width = _bucket(base + chunk)``, so
    attention grows with the content; the wider windows add only masked
    zeros, but other float orders, so logits agree with the one-shot
    prefill within tolerance, not bitwise. ``generate`` pads and prefills
    the residue, then runs the engine's decode loop on the session cache,
    as ``Engine.generate`` does, and retains it as the engine's prefix
    snapshot.

    One full-capacity [1, max_seq] cache is allocated at construction and
    held until ``generate`` consumes it or :meth:`close` drops it. Single
    use; appends serialize on one lock. Ids past the context window set
    ``overflowed`` and stay unprefilled: a written cache cannot be
    middle-out truncated, so the caller takes the classic path.

    A session prefills UNPINNED (it may be abandoned without generating; a
    pin would wedge swaps): ``generate`` pins, and re-prefills from zero if
    a weight swap landed between appends, so the cache never mixes KV of
    two weight versions.
    """

    def __init__(self, engine: Engine):
        if not engine.prefill_chunk:
            raise ValueError("PrefillSession requires chunked prefill (prefill_chunk > 0)")
        self._eng = engine
        self._chunk = engine.prefill_chunk
        self._lock = sanitizer.make_lock("engine.session")
        self._ids: list[int] = []
        self._base = 0  # ids already prefilled (a chunk multiple)
        self._last_logits: Optional[torch.Tensor] = None
        self._done: Optional[torch.cuda.Event] = None  # after the last dispatch (card)
        self._closed = False
        self.overflowed = False
        self._weight_version = engine.weight_version
        self._cache = self._new_cache()

    def _new_cache(self) -> dict:
        eng = self._eng
        with torch.inference_mode():
            return eng.new_cache()

    @property
    def tokens(self) -> int:
        """Tokens appended so far (prefilled and residue)."""
        with self._lock:
            return len(self._ids)

    @property
    def prefilled(self) -> int:
        """Tokens whose prefill has been dispatched (whole chunks)."""
        with self._lock:
            return self._base

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        """Drop the cache; later appends and ``generate`` raise."""
        with self._lock:
            self._closed = True
            self._cache = self._last_logits = None

    def append_text(self, text: str) -> int:
        """Tokenize and append; returns the number of tokens appended. The
        pieces concatenate into one prompt, so a leading BOS is kept only
        on the session's first piece."""
        tok = self._eng.tokenizer
        ids = tok.encode(text)
        bos = getattr(tok, "bos_id", None)
        with self._lock:
            if self._ids and ids and bos is not None and ids[0] == bos:
                ids = ids[1:]
            self._append_locked(ids)
        return len(ids)

    def append(self, ids: list[int]) -> None:
        """Append ``ids``; every whole chunk they complete is dispatched at
        once (asynchronously on a card)."""
        with self._lock:
            self._append_locked(list(ids))

    def _append_locked(self, ids: list[int]) -> None:
        eng, chunk = self._eng, self._chunk
        if self._closed:
            raise RuntimeError("PrefillSession already consumed")
        self._ids.extend(ids)
        # Overflow: the final padded chunk would end past capacity (the
        # classic paths' n_chunks * chunk <= max_seq guard).
        if len(self._ids) >= eng.max_seq or -(-len(self._ids) // chunk) * chunk > eng.max_seq:
            self.overflowed = True
        if self.overflowed:
            return
        while len(self._ids) - self._base >= chunk:
            self._dispatch(self._ids[self._base:self._base + chunk], chunk - 1)
            self._base += chunk

    def _dispatch(self, chunk_ids: list[int], last: int) -> None:
        """One chunk of the session at ``self._base``."""
        eng = self._eng
        kv_width = _bucket(self._base + self._chunk, eng.max_seq)
        cap = eng._capture("prefill", ((1, self._chunk), kv_width), self._chunk)
        with torch.inference_mode(), cap or nullcontext():
            self._last_logits = eng._prefill_chunk(
                eng._ids_tensor(chunk_ids), self._cache, self._base,
                torch.full((1,), last, device=eng.device), kv_width, capture=cap)
        if eng.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()

    def sync(self) -> None:
        """Wait until every dispatched chunk has completed on the device."""
        with self._lock:
            done = self._done
        if done is not None:
            done.synchronize()

    def generate(self, sampling: SamplingParams = SamplingParams(),
                 ctx: Optional[Context] = None,
                 on_text: Optional[Callable[[str], None]] = None) -> GenerateResult:
        """Prefill the residue (one padded final chunk), then decode, with
        the weights pinned. The chunk padding lands at slots >= the prompt
        length, which decode overwrites before its frontier reaches them."""
        eng = self._eng
        eng.pin_weights()
        try:
            return self._generate_pinned(sampling, ctx, on_text)
        finally:
            eng.unpin_weights()

    def _generate_pinned(self, sampling: SamplingParams, ctx: Optional[Context],
                         on_text: Optional[Callable[[str], None]]) -> GenerateResult:
        eng = self._eng
        ctx = ctx or Context.background()
        start_time = time.monotonic()
        with self._lock:
            if self._closed:
                raise RuntimeError("PrefillSession already consumed")
            if self.overflowed:
                raise ValueError("session overflowed the context window; use the classic "
                                 "(truncating) prompt path")
            n = len(self._ids)
            if n == 0:
                raise ValueError("empty prompt")
            if n >= eng.max_seq:
                raise ValueError(f"prompt length {n} exceeds max sequence length {eng.max_seq}")
            if self._base > 0 and eng.weight_version != self._weight_version:
                # A swap landed between appends: the cached chunks hold the
                # old weights' KV. Re-prefill every id under the pinned
                # version (one more prompt pass, never a mixed cache).
                self._base = 0
                self._last_logits = None
                self._cache = self._new_cache()
                self._weight_version = eng.weight_version
                pending, self._ids = self._ids, []
                self._append_locked(pending)
            residue = n - self._base
            if residue > 0:
                if self._base + self._chunk > eng.max_seq:
                    raise ValueError("residue chunk would overrun cache capacity")
                self._dispatch(self._ids[self._base:] + [0] * (self._chunk - residue),
                               residue - 1)
                self._base = n
            ids, last_logits, cache = list(self._ids), self._last_logits, self._cache
            self._closed = True
            self._cache = self._last_logits = None  # consumed by the decode loop
        decoder = StreamDecoder(eng.tokenizer)
        parts: list[str] = []

        def on_token(tok_id: int) -> None:
            text = decoder.push(tok_id)
            if text:
                parts.append(text)
                if on_text is not None:
                    on_text(text)

        with torch.inference_mode():
            result = eng._decode_stream(ids, last_logits, cache, sampling, ctx, on_token,
                                        start_time)
        tail = decoder.flush()
        if tail:
            parts.append(tail)
            if on_text is not None:
                on_text(tail)
        result.text = "".join(parts)
        return result
