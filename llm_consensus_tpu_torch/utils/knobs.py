"""Environment knobs of the port, read at one boundary only: the CLI's
provider factory (``cli/main.py``). Engines and providers take explicit
arguments and read no environment.

The parsing is the JAX package's (``llm_consensus_tpu/utils/knobs.py``
``get_str``/``get_bool``): an unset or empty value means the default, and
``0``/``false``/``no``/``off`` in any case mean False. The port reads only
knobs that the JAX package declares, with the same meaning:

  * ``LLMC_QUANT``: weight quantization, ``int8`` or ``int4``;
  * ``LLMC_KV_QUANT``: KV-cache quantization, ``int8``;
  * ``LLMC_W8A8``: int8 x int8 matmuls (int8 weights only);
  * ``LLMC_DECODE_W8A8``: int8 x int8 decode-attention scores (int8 KV
    cache, GQA group 2 to 4), turned off by ``LLMC_DECODE_QSTRUCT=0``;
  * ``LLMC_INT4_IMPL``: the int4 matmul lowering, ``auto`` or ``nibble``.
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
