"""Cross-request paged KV pool with radix prefix sharing (port of
``llm_consensus_tpu/kv/``).

The engine's prefix snapshot keeps ONE prompt's cache: a second distinct
prefix evicts the first. This package generalizes that slot into a cache
across requests:

  * :mod:`kv.pool` — a block-granular paged KV pool: fixed-size token
    blocks over one preallocated arena per engine (an ``init_kv_cache``
    of ``n_blocks x block_size`` slots), leases, copy-on-write on
    divergence, LRU eviction of unreferenced blocks;
  * :mod:`kv.radix` — a token-id radix trie mapping prompt prefixes to
    block chains, shared across streams, requests and consensus rounds.

Wiring: an engine built with ``kv_pool=True`` replaces its snapshot with
the pool: ``Engine._reusable_prefix`` becomes a radix match and a block
gather, ``Engine._retain_prefix`` a block publish. So every reuse path the
engine has rides on it unchanged (the single-stream restore, the admission
wave's fork, the batcher's shared-prefix establishment), and with the pool
off those paths are exactly as before. The engine reads no environment: the
CLI's provider factory resolves ``LLMC_KV_POOL``, ``LLMC_KV_POOL_BLOCK`` and
``LLMC_KV_POOL_MB`` (``utils/knobs.py`` ``kv_pool_settings``) into the
engines' arguments.

Blocks hold exact cache bytes (the copies move the leaves' bytes, int8
codes and scales included) at absolute positions ``[0, n)`` of a
left-aligned ``[1, S]`` cache, so a gathered prefix is bit-identical to a
snapshot restore and greedy decode is identical pool on and off.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.kv.pool import KVPool
from llm_consensus_tpu_torch.kv.radix import RadixIndex

__all__ = ["KVPool", "RadixIndex", "pool_for"]


def pool_for(engine) -> Optional[KVPool]:
    """The engine's KV pool, or None: when the engine was built with
    ``kv_pool=False``, or without chunked prefill (``prefill_chunk == 0``:
    the gather's tail prefills in chunks), or with the prefix cache off,
    exactly the JAX package's gates."""
    if not engine.kv_pool_requested:
        return None
    if not engine.prefill_chunk or not engine.prefix_cache_enabled:
        return None
    return KVPool.for_engine(engine)
