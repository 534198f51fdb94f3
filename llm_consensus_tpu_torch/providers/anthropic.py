"""Anthropic provider: the Messages API (a copy of
``llm_consensus_tpu/providers/anthropic.py``).

POST ``{base}/messages`` with ``max_tokens`` 4096, the headers
``x-api-key`` and ``anthropic-version: 2023-06-01``, and the system prompt
as ``system``; a stream keeps the ``content_block_delta`` events that carry
a ``text_delta``. The key comes from ``ANTHROPIC_API_KEY``, the base URL
from ``ANTHROPIC_BASE_URL``.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.providers.base import Request
from llm_consensus_tpu_torch.providers.http_sse import RemoteProvider

MAX_TOKENS = 4096
API_VERSION = "2023-06-01"


class AnthropicProvider(RemoteProvider):
    name = "anthropic"
    KEY_ENV = "ANTHROPIC_API_KEY"
    BASE_ENV = "ANTHROPIC_BASE_URL"
    DEFAULT_BASE_URL = "https://api.anthropic.com/v1"

    def _url(self, req: Request, stream: bool) -> str:
        return f"{self._base}/messages"

    def _headers(self) -> dict[str, str]:
        return {"x-api-key": self._key, "anthropic-version": API_VERSION}

    def _body(self, req: Request, stream: bool) -> dict:
        body = {
            "model": req.model,
            "max_tokens": MAX_TOKENS,
            "messages": [{"role": "user", "content": req.prompt}],
        }
        if req.system:
            body["system"] = req.system
        if stream:
            body["stream"] = True
        return body

    @staticmethod
    def _text(data: dict) -> str:
        return "".join(b.get("text", "") for b in data.get("content", [])
                       if b.get("type") == "text")

    @staticmethod
    def _delta(event: dict) -> Optional[str]:
        if event.get("type") == "content_block_delta":
            delta = event.get("delta", {})
            if delta.get("type") == "text_delta":
                return delta.get("text") or None
        return None
