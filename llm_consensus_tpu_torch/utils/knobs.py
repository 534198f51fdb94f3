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
  * ``LLMC_CONFIG``: the CLI's config file (:func:`config_file`).
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
