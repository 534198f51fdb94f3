"""OpenAI provider: the Responses API (a copy of
``llm_consensus_tpu/providers/openai.py``).

POST ``{base}/responses`` with ``{model, input, stream}`` and the system
prompt as ``instructions``; a stream keeps the
``response.output_text.delta`` events; a whole response walks
``output[].content[]`` for ``output_text`` items. The key comes from
``OPENAI_API_KEY``, the base URL from ``OPENAI_BASE_URL`` (tests and
proxies).
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.providers.base import Request
from llm_consensus_tpu_torch.providers.http_sse import RemoteProvider


class OpenAIProvider(RemoteProvider):
    name = "openai"
    KEY_ENV = "OPENAI_API_KEY"
    BASE_ENV = "OPENAI_BASE_URL"
    DEFAULT_BASE_URL = "https://api.openai.com/v1"

    def _url(self, req: Request, stream: bool) -> str:
        return f"{self._base}/responses"

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self._key}"}

    def _body(self, req: Request, stream: bool) -> dict:
        body = {"model": req.model, "input": req.prompt}
        if req.system:
            body["instructions"] = req.system
        if stream:
            body["stream"] = True
        return body

    @staticmethod
    def _text(data: dict) -> str:
        return "".join(
            content.get("text", "")
            for item in data.get("output", [])
            for content in item.get("content", [])
            if content.get("type") == "output_text"
        )

    @staticmethod
    def _delta(event: dict) -> Optional[str]:
        if event.get("type") == "response.output_text.delta":
            return event.get("delta") or None
        return None
