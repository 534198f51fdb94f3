"""Environment knobs of the port, read at one boundary only: the CLI
(``cli/main.py``: its provider factory, its telemetry planes and its
config file). Engines and providers take explicit arguments and read no
``LLMC_*`` variable (the remote HTTP providers read their API keys and
base URLs themselves, as the JAX ones do).

The parsing is the JAX package's (``llm_consensus_tpu/utils/knobs.py``
``get_str``/``get_bool``): an unset or empty value means the default, and
``0``/``false``/``no``/``off`` in any case mean False. The port reads only
knobs that the JAX package declares, with the same meaning:

  * ``LLMC_QUANT``: weight quantization, ``int8`` or ``int4``;
  * ``LLMC_KV_QUANT``: KV-cache quantization, ``int8``;
  * ``LLMC_W8A8``: int8 x int8 matmuls (int8 weights only);
  * ``LLMC_DECODE_W8A8``: int8 x int8 decode-attention scores (int8 KV
    cache, GQA group 2 to 4), turned off by ``LLMC_DECODE_QSTRUCT=0``;
  * ``LLMC_INT4_IMPL``: the int4 matmul lowering, ``auto`` or ``nibble``;
  * ``LLMC_MAX_BATCH`` (falling back to ``LLMC_BATCH_STREAMS``): slots of
    the continuous-batching pool per preset, above 1 to batch;
  * ``LLMC_POOL_PREFIX``, ``LLMC_POOL_PREFIX_MIN``: shared-prefix serving
    and its minimum common prefix;
  * ``LLMC_PREFILL_BUDGET`` (0): interleaved admission, the prompt tokens
    of a new wave's prefill dispatched between two decode chunks (0:
    classic admission);
  * ``LLMC_POOL_BUCKET`` (on): occupancy row-bucketing of the pool cache;
  * ``LLMC_PRESSURE_PREEMPT`` (on): priority preemption in the batcher;
  * ``LLMC_PRESSURE_DEADLINE_HIGH_S`` (15 s) and
    ``LLMC_PRESSURE_DEADLINE_LOW_S`` (600 s): the deadlines that derive a
    request's priority class when it states none
    (``pressure/priority.py`` ``resolve_priority``);
  * ``LLMC_CHECKPOINT_DIR``: the directory of per-preset HF safetensors
    checkpoints (``<dir>/<preset>/``);
  * ``LLMC_PREFIX_CACHE`` (default on) and ``LLMC_PREFIX_CACHE_MAX_MB``
    (2048; MB = 1e6 bytes): the engines' prefix snapshot reuse and its cap;
  * ``LLMC_JUDGE_OVERLAP``: the judge prompt prefills as panel answers
    arrive (``--judge-overlap``);
  * ``LLMC_HTTP_RETRIES`` (2) and ``LLMC_HTTP_BACKOFF`` (0.5 s, doubling
    per attempt): the remote providers' retries of transient failures;
  * the telemetry planes (:func:`telemetry_settings`, installed by the CLI
    before any provider exists): ``LLMC_EVENTS`` and ``LLMC_EVENTS_MAX``
    (the recorder), ``LLMC_LIVE`` (default on), ``LLMC_LIVE_WINDOW_S``,
    ``LLMC_LIVE_WINDOWS``, ``LLMC_ATTRIB`` ("0" off, unset follows
    ``LLMC_LIVE``), ``LLMC_ATTRIB_WARMUP_S``, ``LLMC_ATTRIB_HBM_HIGH``,
    ``LLMC_ROOFLINE`` ("0" off, unset follows attribution),
    ``LLMC_ROOFLINE_RIDGE``, ``LLMC_ROOFLINE_TOL``, ``LLMC_BLACKBOX``
    (default on), ``LLMC_BLACKBOX_EVENTS``, ``LLMC_BLACKBOX_DIR``,
    ``LLMC_BLACKBOX_MIN_INTERVAL_S``, ``LLMC_PROFILE`` (default on),
    ``LLMC_PROFILE_DIR``, ``LLMC_PROFILE_MAX_S``,
    ``LLMC_PROFILE_MIN_INTERVAL_S``, with the JAX package's defaults;
  * ``LLMC_CONFIG``: the CLI's config file (:func:`config_file`);
  * the fault plan (:func:`fault_settings`, installed by the CLI):
    ``LLMC_FAULTS`` (the spec, empty: none) and ``LLMC_FAULTS_SEED`` (0);
  * crash recovery (:func:`recovery_settings`, ``GPUProvider.shared``'s
    arguments): ``LLMC_JOURNAL`` (``1`` journals in memory, a directory also
    mirrors each stream to ``.wal`` files; empty or ``0``: off),
    ``LLMC_ENGINE_HEARTBEAT_S`` (0.0: no wedge watchdog) and
    ``LLMC_ENGINE_RESTARTS`` (3 replays a stream);
  * ``LLMC_INTEGRITY`` (off): the integrity plane (:func:`integrity_enabled`,
    installed by the CLI), and ``LLMC_INTEGRITY_SAMPLE`` (0.05): the share
    of the KV pool's gathers it verifies (:func:`integrity_sample`);
  * the cross-request KV pool (:func:`kv_pool_settings`, ``GPUProvider``'s
    and ``Engine``'s arguments): ``LLMC_KV_POOL`` (off),
    ``LLMC_KV_POOL_BLOCK`` (64 tokens a block) and ``LLMC_KV_POOL_MB``
    (256; the arena's budget, MB = 1e6 bytes);
  * speculative decoding (:func:`spec_settings`, ``GPUProvider``'s
    arguments): ``LLMC_DRAFT`` (empty: none; the ``--draft`` syntax),
    ``LLMC_SPEC_K`` (4, the draft-length ceiling), ``LLMC_SPEC_NGRAM`` (3,
    the prompt-lookup gram), ``LLMC_SPEC_ADAPT`` (on: the adaptive k
    ladder), ``LLMC_SPEC_GOVERNOR`` (on: the drafted-vs-plain A/B) and
    ``LLMC_SPEC_PROBE`` (64 tokens a governor window);
  * the ``serve`` subcommand (:func:`serve_settings`,
    :func:`pressure_settings`, :func:`live_settings`, read by
    ``cli/serve.py`` and passed to the gateway, the governor, the
    admission controller and the engines as arguments):
    ``LLMC_ELASTIC_WARM_S`` (0: serve at once), ``LLMC_INTEGRITY_QUARANTINE_AFTER``
    (3) and ``LLMC_INTEGRITY_PROBE_N`` (3), ``LLMC_SWAP_WAIT_S`` (30 s),
    ``LLMC_FLEET_ANNOUNCE`` (the router a gateway announces itself to, empty:
    none), the governor's
    ``LLMC_PRESSURE`` (on), ``LLMC_PRESSURE_POLL_S`` (0.5 s),
    ``LLMC_PRESSURE_HIGH_WATER`` (0.75), ``LLMC_PRESSURE_LOW_WATER`` (0.35),
    ``LLMC_PRESSURE_UP_PATIENCE`` (2), ``LLMC_PRESSURE_DOWN_PATIENCE`` (4),
    ``LLMC_PRESSURE_EVICT_TARGET`` (0.7), ``LLMC_PRESSURE_JUDGE_FALLBACK``
    (empty), ``LLMC_PRESSURE_BROWNOUT_MAX_NEW`` (256),
    ``LLMC_PRESSURE_SHED_CLASS`` (2), the admission's ``LLMC_PRESSURE_AGE_S``
    (30 s) and ``LLMC_PRESSURE_RETRY_SPREAD`` (0.5), and the SLO watcher's
    ``LLMC_SLO_TTFT_P99_S`` (0: off) and ``LLMC_SLO_WINDOWS`` (3);
  * the engines' capacity and prefill (:func:`engine_settings`,
    ``GPUProvider``'s arguments): ``LLMC_MAX_SEQ`` (0: the preset's window)
    caps every engine's context, and ``LLMC_PREFILL_CHUNK`` (512; 0 turns
    chunking off) is the chunked prefill's length;
  * ``LLMC_STALL_GRACE`` (5 s, :func:`stall_grace`): how long past its
    deadline a silent panel worker runs before the runner abandons it;
  * the fleet tier (:func:`fleet_settings`, :func:`elastic_settings`, read
    by ``cli/route.py`` and ``cli/serve.py`` and passed to the router, the
    health monitor, the elastic controller and the gateway's heartbeat):
    ``LLMC_FLEET_POLL_S`` (2 s), ``LLMC_FLEET_SUSPECT_AFTER`` (1),
    ``LLMC_FLEET_DEAD_AFTER`` (3), ``LLMC_FLEET_REVIVE_AFTER`` (2),
    ``LLMC_FLEET_SATURATION`` (0.85), ``LLMC_FLEET_SPILLOVER_MIN_TIMEOUT_S``
    (10 s), ``LLMC_FLEET_SPILLOVER_MAX_PRIORITY`` (1),
    ``LLMC_FLEET_HEARTBEAT_S`` (2 s), ``LLMC_CANARY_FRACTION`` (0: no canary
    lane), and ``LLMC_ELASTIC`` (off: the controller's tick thread),
    ``LLMC_ELASTIC_TICK_S`` (2 s), ``LLMC_ELASTIC_HIGH_WATER`` (0.8),
    ``LLMC_ELASTIC_LOW_WATER`` (0.2), ``LLMC_ELASTIC_UP_PATIENCE`` (3),
    ``LLMC_ELASTIC_DOWN_PATIENCE`` (6), ``LLMC_ELASTIC_MIN_REPLICAS`` (1),
    ``LLMC_ELASTIC_MAX_REPLICAS`` (8) and ``LLMC_ELASTIC_MIGRATE_TIMEOUT_S``
    (10 s);
  * disaggregated prefill → decode (:func:`disagg_settings`,
    ``GPUProvider``'s arguments): ``LLMC_DISAGG`` (off),
    ``LLMC_DISAGG_DEPTH`` (8, the handoff queue's bound),
    ``LLMC_DISAGG_WAVE`` (4 prompts a prefill wave), ``LLMC_DISAGG_WAIT_S``
    (30 s, a submitter's bounded wait) and ``LLMC_DISAGG_OVERLAP`` (on: the
    polled wait);
  * the data flywheel (:func:`data_dir` and :func:`flywheel_settings`, read
    by ``cli/distill.py`` and passed as arguments): ``LLMC_DATA_DIR`` (``data``, the run tree the corpus
    scans), ``LLMC_DISTILL_LR`` (1e-4), ``LLMC_DISTILL_STEPS`` (20),
    ``LLMC_DISTILL_BATCH`` (2), ``LLMC_DISTILL_SEQ`` (128),
    ``LLMC_DISTILL_TEMP`` (2.0), ``LLMC_DISTILL_ALPHA`` (0.5),
    ``LLMC_DISTILL_HOLDOUT`` (0.2) and ``LLMC_DISTILL_CKPT_EVERY`` (0: one
    checkpoint at the end).
"""

from __future__ import annotations

import os

_FALSY = ("0", "false", "no", "off")


def get_str(name: str, default: str = "") -> str:
    """The stripped value, or ``default`` when unset or empty."""
    v = (os.environ.get(name) or "").strip()
    return v if v else default


def get_bool(name: str, default: bool = False) -> bool:
    """Unset/empty → ``default``; ``0/false/no/off`` (any case) → False;
    anything else → True."""
    v = (os.environ.get(name) or "").strip()
    if not v:
        return bool(default)
    return v.lower() not in _FALSY


def get_int(name: str, default: int) -> int:
    """Unset, empty or unparsable → ``default``."""
    v = (os.environ.get(name) or "").strip()
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    """Unset, empty or unparsable → ``default``."""
    v = (os.environ.get(name) or "").strip()
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _tristate(name: str, follows: bool) -> bool:
    """The JAX planes' switch: "0" off, any other value on, unset
    ``follows``."""
    v = get_str(name)
    return follows if not v else v != "0"


def telemetry_settings() -> dict:
    """The telemetry planes' switches and settings of the environment,
    with the JAX package's defaults and its follow rules (attribution
    follows the live plane, the roofline follows attribution)."""
    live = get_bool("LLMC_LIVE", True)
    attrib = _tristate("LLMC_ATTRIB", live)
    events = get_str("LLMC_EVENTS")
    return {
        "events": bool(events) and events != "0",
        "events_max": get_int("LLMC_EVENTS_MAX", 200_000),
        "live": live,
        "live_window_s": get_float("LLMC_LIVE_WINDOW_S", 10.0),
        "live_windows": get_int("LLMC_LIVE_WINDOWS", 30),
        "attrib": attrib,
        "attrib_warmup_s": get_float("LLMC_ATTRIB_WARMUP_S", 120.0),
        "attrib_hbm_high": get_float("LLMC_ATTRIB_HBM_HIGH", 0.92),
        "roofline": _tristate("LLMC_ROOFLINE", attrib),
        "roofline_ridge": get_float("LLMC_ROOFLINE_RIDGE", 0.0),
        "roofline_tol": get_float("LLMC_ROOFLINE_TOL", 4.0),
        "blackbox": get_bool("LLMC_BLACKBOX", True),
        "blackbox_events": get_int("LLMC_BLACKBOX_EVENTS", 4096),
        "blackbox_dir": get_str("LLMC_BLACKBOX_DIR"),
        "blackbox_min_interval_s": get_float("LLMC_BLACKBOX_MIN_INTERVAL_S", 30.0),
        "profile": get_bool("LLMC_PROFILE", True),
        "profile_dir": get_str("LLMC_PROFILE_DIR"),
        "profile_max_s": get_float("LLMC_PROFILE_MAX_S", 10.0),
        "profile_min_interval_s": get_float("LLMC_PROFILE_MIN_INTERVAL_S", 60.0),
    }


def batch_settings() -> dict:
    """The continuous-batching settings of the environment, as the keyword
    arguments of ``GPUProvider``."""
    return {
        "batch_streams": get_int("LLMC_MAX_BATCH", 0) or get_int("LLMC_BATCH_STREAMS", 1),
        "pool_prefix": get_bool("LLMC_POOL_PREFIX", True),
        "pool_prefix_min": get_int("LLMC_POOL_PREFIX_MIN", 192),
        "prefill_budget": max(0, get_int("LLMC_PREFILL_BUDGET", 0)),
        "pool_bucket": get_bool("LLMC_POOL_BUCKET", True),
        "preempt": get_bool("LLMC_PRESSURE_PREEMPT", True),
    }


def set_prefill_budget(tokens: int) -> None:
    """The CLI's ``--prefill-budget``: set ``LLMC_PREFILL_BUDGET`` for the
    process, so the flag and the knob are one setting (as in the JAX
    CLI)."""
    os.environ["LLMC_PREFILL_BUDGET"] = str(tokens)


def priority_deadlines() -> tuple[float, float]:
    """``(high_s, low_s)``: a request deadline at or under ``high_s`` reads
    as the HIGH class, one at or over ``low_s`` as LOW."""
    return (get_float("LLMC_PRESSURE_DEADLINE_HIGH_S", 15.0),
            get_float("LLMC_PRESSURE_DEADLINE_LOW_S", 600.0))


def quant_modes() -> dict:
    """The quantization settings of the environment, as the keyword
    arguments of ``GPUProvider`` and ``Engine`` (modes unvalidated: the
    provider validates them before it builds anything)."""
    return {
        "quant": get_str("LLMC_QUANT") or None,
        "kv_quant": get_str("LLMC_KV_QUANT") or None,
        "w8a8": get_bool("LLMC_W8A8"),
        "decode_w8a8": get_bool("LLMC_DECODE_W8A8") and get_bool("LLMC_DECODE_QSTRUCT", True),
        "int4_impl": get_str("LLMC_INT4_IMPL", "auto"),
    }


def checkpoint_dir() -> dict:
    """The checkpoint directory of the environment, as the keyword argument
    of ``GPUProvider`` (None when unset)."""
    return {"checkpoint_dir": get_str("LLMC_CHECKPOINT_DIR") or None}


def prefix_settings() -> dict:
    """The prefix snapshot settings of the environment, as the keyword
    arguments of ``GPUProvider`` and ``Engine``."""
    return {
        "prefix_cache": get_bool("LLMC_PREFIX_CACHE", True),
        "prefix_cache_max_mb": get_float("LLMC_PREFIX_CACHE_MAX_MB", 2048.0),
    }


def judge_overlap() -> bool:
    """``LLMC_JUDGE_OVERLAP``: the judge-overlap default (off)."""
    return get_bool("LLMC_JUDGE_OVERLAP")


def http_settings() -> dict:
    """The remote providers' retry settings of the environment, as their
    keyword arguments (a malformed value means the default)."""
    return {
        "retries": max(0, get_int("LLMC_HTTP_RETRIES", 2)),
        "backoff": get_float("LLMC_HTTP_BACKOFF", 0.5),
    }


def config_file() -> str:
    """``LLMC_CONFIG``, the CLI's config file: ``"0"`` disables it, a path
    overrides the search, unset (or empty) means search."""
    return get_str("LLMC_CONFIG")


def fault_settings() -> dict:
    """The fault plan of the environment: ``spec`` (empty: no plan) and
    ``seed``."""
    return {"spec": get_str("LLMC_FAULTS"), "seed": get_int("LLMC_FAULTS_SEED", 0)}


def recovery_settings() -> dict:
    """The crash-recovery settings of the environment, as the keyword
    arguments of ``GPUProvider.shared``."""
    journal = get_str("LLMC_JOURNAL")
    return {
        "journal": "" if journal == "0" else journal,
        "engine_heartbeat_s": get_float("LLMC_ENGINE_HEARTBEAT_S", 0.0),
        "engine_restarts": get_int("LLMC_ENGINE_RESTARTS", 3),
    }


def integrity_enabled() -> bool:
    """``LLMC_INTEGRITY``: the integrity plane's switch (off)."""
    return get_bool("LLMC_INTEGRITY")


def integrity_sample() -> float:
    """``LLMC_INTEGRITY_SAMPLE``: the share of KV-pool gathers the plane
    verifies (0.05)."""
    return get_float("LLMC_INTEGRITY_SAMPLE", 0.05)


def kv_pool_settings(default_on: bool = False) -> dict:
    """The KV pool settings of the environment, as the keyword arguments of
    ``GPUProvider`` and ``Engine``; ``default_on`` is the pool's switch when
    ``LLMC_KV_POOL`` is unset (``serve --disagg`` implies the pool)."""
    return {
        "kv_pool": get_bool("LLMC_KV_POOL", default_on),
        "kv_pool_block": get_int("LLMC_KV_POOL_BLOCK", 64),
        "kv_pool_mb": get_float("LLMC_KV_POOL_MB", 256.0),
    }


def spec_settings() -> dict:
    """The speculative-decoding settings of the environment, as the keyword
    arguments of ``GPUProvider`` (the JAX defaults; k and the gram at
    least 1)."""
    return {
        "draft": get_str("LLMC_DRAFT"),
        "spec_k": max(1, get_int("LLMC_SPEC_K", 4)),
        "spec_ngram": max(1, get_int("LLMC_SPEC_NGRAM", 3)),
        "spec_adapt": get_bool("LLMC_SPEC_ADAPT", True),
        "spec_governor": get_bool("LLMC_SPEC_GOVERNOR", True),
        "spec_probe": get_int("LLMC_SPEC_PROBE", 64),
    }


def serve_settings() -> dict:
    """The ``serve`` subcommand's settings of the environment (the JAX
    defaults): the gateway's warm-up and quarantine, the engines' swap wait,
    the batcher depth's fallback (0: the subcommand's default), the router
    to announce to (``announce``, empty: none) and the fallback of
    ``--disagg`` (``disagg``)."""
    return {
        "elastic_warm_s": get_float("LLMC_ELASTIC_WARM_S", 0.0),
        "quarantine_after": get_int("LLMC_INTEGRITY_QUARANTINE_AFTER", 3),
        "probe_n": get_int("LLMC_INTEGRITY_PROBE_N", 3),
        "swap_wait_s": get_float("LLMC_SWAP_WAIT_S", 30.0),
        "max_batch": get_int("LLMC_MAX_BATCH", 0) or get_int("LLMC_BATCH_STREAMS", 0),
        "announce": get_str("LLMC_FLEET_ANNOUNCE"),
        "disagg": get_bool("LLMC_DISAGG"),
    }


def pressure_settings() -> dict:
    """The pressure governor's and the admission controller's settings of
    the environment (the JAX defaults); ``enabled`` is the governor's kill
    switch."""
    return {
        "enabled": get_bool("LLMC_PRESSURE", True),
        "poll_s": get_float("LLMC_PRESSURE_POLL_S", 0.5),
        "high_water": get_float("LLMC_PRESSURE_HIGH_WATER", 0.75),
        "low_water": get_float("LLMC_PRESSURE_LOW_WATER", 0.35),
        "up_patience": get_int("LLMC_PRESSURE_UP_PATIENCE", 2),
        "down_patience": get_int("LLMC_PRESSURE_DOWN_PATIENCE", 4),
        "evict_target": get_float("LLMC_PRESSURE_EVICT_TARGET", 0.7),
        "judge_fallback": get_str("LLMC_PRESSURE_JUDGE_FALLBACK"),
        "brownout_max_new": get_int("LLMC_PRESSURE_BROWNOUT_MAX_NEW", 256),
        "shed_class": get_int("LLMC_PRESSURE_SHED_CLASS", 2),
        "age_s": get_float("LLMC_PRESSURE_AGE_S", 30.0),
        "retry_spread": get_float("LLMC_PRESSURE_RETRY_SPREAD", 0.5),
    }


def live_settings() -> dict:
    """The SLO-burn watcher's settings of the environment: the p99 TTFT
    threshold (0 disables) and the consecutive windows that fire a dump."""
    return {
        "slo_ttft_p99_s": get_float("LLMC_SLO_TTFT_P99_S", 0.0),
        "slo_windows": get_int("LLMC_SLO_WINDOWS", 3),
    }


def engine_settings() -> dict:
    """The engines' context cap and chunked-prefill length of the
    environment, as the keyword arguments of ``GPUProvider`` (``max_seq``
    None: each preset's own window)."""
    return {
        "max_seq": get_int("LLMC_MAX_SEQ", 0) or None,
        "prefill_chunk": max(0, get_int("LLMC_PREFILL_CHUNK", 512)),
    }


def stall_grace() -> float:
    """``LLMC_STALL_GRACE``: seconds past its deadline a panel worker that
    streams nothing may run before the runner abandons it (5)."""
    return get_float("LLMC_STALL_GRACE", 5.0)


def fleet_settings() -> dict:
    """The fleet tier's settings of the environment (the JAX defaults): the
    health monitor's cadence and hysteresis counts, placement's saturation
    mark, the spillover lane's gates, the gateway heartbeat's cadence and
    the canary lane's share of the keyspace."""
    return {
        "poll_s": get_float("LLMC_FLEET_POLL_S", 2.0),
        "suspect_after": get_int("LLMC_FLEET_SUSPECT_AFTER", 1),
        "dead_after": get_int("LLMC_FLEET_DEAD_AFTER", 3),
        "revive_after": get_int("LLMC_FLEET_REVIVE_AFTER", 2),
        "saturation": get_float("LLMC_FLEET_SATURATION", 0.85),
        "spillover_min_timeout_s": get_float("LLMC_FLEET_SPILLOVER_MIN_TIMEOUT_S", 10.0),
        "spillover_max_priority": get_int("LLMC_FLEET_SPILLOVER_MAX_PRIORITY", 1),
        "heartbeat_s": get_float("LLMC_FLEET_HEARTBEAT_S", 2.0),
        "canary_fraction": get_float("LLMC_CANARY_FRACTION", 0.0),
    }


def elastic_settings() -> dict:
    """The elastic controller's settings of the environment (the JAX
    defaults): its tick thread's switch (``enabled``) and cadence, the
    two-sided hysteresis, the replica clamps, and the source's bounded wait
    for a destination to take one migrated stream."""
    return {
        "enabled": get_bool("LLMC_ELASTIC"),
        "tick_s": get_float("LLMC_ELASTIC_TICK_S", 2.0),
        "high_water": get_float("LLMC_ELASTIC_HIGH_WATER", 0.8),
        "low_water": get_float("LLMC_ELASTIC_LOW_WATER", 0.2),
        "up_patience": get_int("LLMC_ELASTIC_UP_PATIENCE", 3),
        "down_patience": get_int("LLMC_ELASTIC_DOWN_PATIENCE", 6),
        "min_replicas": get_int("LLMC_ELASTIC_MIN_REPLICAS", 1),
        "max_replicas": get_int("LLMC_ELASTIC_MAX_REPLICAS", 8),
        "migrate_timeout_s": get_float("LLMC_ELASTIC_MIGRATE_TIMEOUT_S", 10.0),
    }


def disagg_settings() -> dict:
    """Disaggregated prefill → decode of the environment, as the keyword
    arguments of ``GPUProvider`` (the JAX defaults)."""
    return {
        "disagg": get_bool("LLMC_DISAGG"),
        "disagg_depth": max(1, get_int("LLMC_DISAGG_DEPTH", 8)),
        "disagg_wave": max(1, get_int("LLMC_DISAGG_WAVE", 4)),
        "disagg_wait_s": get_float("LLMC_DISAGG_WAIT_S", 30.0),
        "disagg_overlap": get_bool("LLMC_DISAGG_OVERLAP", True),
    }


def data_dir() -> str:
    """``LLMC_DATA_DIR``: the run tree the flywheel's corpus scans."""
    return get_str("LLMC_DATA_DIR", "data")


def flywheel_settings() -> dict:
    """The distillation settings of the environment, as the keyword
    arguments of ``flywheel.distill.run_distill`` (the JAX defaults) plus
    the corpus's ``holdout`` share."""
    return {
        "lr": get_float("LLMC_DISTILL_LR", 1e-4),
        "steps": get_int("LLMC_DISTILL_STEPS", 20),
        "batch": get_int("LLMC_DISTILL_BATCH", 2),
        "seq": get_int("LLMC_DISTILL_SEQ", 128),
        "temperature": get_float("LLMC_DISTILL_TEMP", 2.0),
        "alpha": get_float("LLMC_DISTILL_ALPHA", 0.5),
        "holdout": get_float("LLMC_DISTILL_HOLDOUT", 0.2),
        "ckpt_every": get_int("LLMC_DISTILL_CKPT_EVERY", 0),
    }
