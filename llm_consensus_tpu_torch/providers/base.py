"""Provider abstraction, the seam between orchestration and compute (a
copy of ``llm_consensus_tpu/providers/base.py``, cut to the fields the
port's device provider fills).

``latency_ms`` holds milliseconds. The on-device extensions (``truncated``,
``tokens``, ``tokens_per_sec``, ``mfu``, ``mbu``, ``spec``, ``kv``) serialize only
when set, so the JSON shape is the JAX package's.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Optional

from llm_consensus_tpu_torch.utils.context import Context

# Called once per streamed chunk of incremental text.
StreamCallback = Callable[[str], None]


@dataclass(frozen=True)
class Request:
    """All inputs for one LLM query."""

    model: str
    prompt: str
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    system: Optional[str] = None
    # Priority class (HIGH=0 / NORMAL=1 / LOW=2; None is NORMAL): the
    # judge's work outranks the panel's. The provider labels its per-token
    # latency with it (obs/live.py ``class_label``).
    priority: Optional[int] = None
    # Cross-hop trace id (obs/live.py), minted at the router or the gateway:
    # the provider stamps it on its engine spans and the journal entry.
    # None outside the serving path.
    trace_id: Optional[str] = None
    # A migrated stream's resume payload (serve/elastic.py): the sealed
    # journal snapshot ``{"prompt_ids", "sampling", "tokens"}``, which the
    # gpu provider replays, or an emitted-text prefix ``{"text": ...}``,
    # which providers ignore (greedy decode re-derives it).
    resume: Optional[dict] = None


@dataclass
class Response:
    """Result of one LLM query."""

    model: str
    content: str
    provider: str
    latency_ms: float = 0.0
    truncated: bool = False
    tokens: Optional[int] = None
    tokens_per_sec: Optional[float] = None
    mfu: Optional[float] = None
    mbu: Optional[float] = None  # memory-bandwidth utilization (decode)
    # Speculative decoding's summary of this query (engine/speculative.py:
    # rounds, accepted tokens, governor state); None on the plain paths.
    spec: Optional[dict] = None
    # KV-reuse degradation of this query: {"truncated": True} when the
    # paged KV pool's arena ran out while publishing this context.
    kv: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "model": self.model,
            "content": self.content,
            "provider": self.provider,
            "latency_ms": self.latency_ms,
        }
        if self.truncated:
            d["truncated"] = True
        if self.tokens is not None:
            d["tokens"] = self.tokens
        if self.tokens_per_sec is not None:
            d["tokens_per_sec"] = round(self.tokens_per_sec, 2)
        if self.mfu is not None:
            d["mfu"] = round(self.mfu, 4)
        if self.mbu is not None:
            d["mbu"] = round(self.mbu, 4)
        if self.spec is not None:
            d["spec"] = dict(self.spec)
        if self.kv is not None:
            d["kv"] = dict(self.kv)
        return d


class Provider(abc.ABC):
    """Abstracts LLM interactions (the port has the on-device GPU engine)."""

    def prepare(self, models: list[str], judge: Optional[str]) -> None:
        """Announce the full run composition before any query. Default:
        no-op; the GPU provider builds its kernels here, before the
        panel's threads start."""

    @abc.abstractmethod
    def query(self, ctx: Context, req: Request) -> Response:
        """Send a prompt and return the complete response."""

    @abc.abstractmethod
    def query_stream(
        self, ctx: Context, req: Request, callback: Optional[StreamCallback]
    ) -> Response:
        """Send a prompt, invoking ``callback`` per chunk; returns the full response."""


class ProviderFunc(Provider):
    """Function adapter implementing Provider: ``query_stream`` calls the
    function once and fires the callback with the full content."""

    def __init__(self, fn: Callable[[Context, Request], Response]):
        self._fn = fn

    def query(self, ctx: Context, req: Request) -> Response:
        return self._fn(ctx, req)

    def query_stream(
        self, ctx: Context, req: Request, callback: Optional[StreamCallback]
    ) -> Response:
        resp = self.query(ctx, req)
        if callback is not None:
            callback(resp.content)
        return resp
