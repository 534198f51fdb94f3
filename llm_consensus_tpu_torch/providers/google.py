"""Google provider: Gemini ``generateContent`` (a copy of
``llm_consensus_tpu/providers/google.py``).

POST ``{base}/models/{model}:generateContent?key=...`` (the key in the URL,
the model in the path) with the system prompt as ``systemInstruction``; a
stream is ``:streamGenerateContent?key=...&alt=sse``, each event a whole
response whose chunk is ``candidates[0].content.parts[].text``. The key
comes from ``GOOGLE_API_KEY``, the base URL from ``GOOGLE_BASE_URL``.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.providers.base import Request
from llm_consensus_tpu_torch.providers.http_sse import RemoteProvider


class GoogleProvider(RemoteProvider):
    name = "google"
    KEY_ENV = "GOOGLE_API_KEY"
    BASE_ENV = "GOOGLE_BASE_URL"
    DEFAULT_BASE_URL = "https://generativelanguage.googleapis.com/v1beta"

    def _url(self, req: Request, stream: bool) -> str:
        if stream:
            return f"{self._base}/models/{req.model}:streamGenerateContent?key={self._key}&alt=sse"
        return f"{self._base}/models/{req.model}:generateContent?key={self._key}"

    def _body(self, req: Request, stream: bool) -> dict:
        body = {"contents": [{"parts": [{"text": req.prompt}]}]}
        if req.system:
            body["systemInstruction"] = {"parts": [{"text": req.system}]}
        return body

    @staticmethod
    def _text(data: dict) -> str:
        candidates = data.get("candidates") or []
        if not candidates:
            return ""
        parts = (candidates[0].get("content") or {}).get("parts") or []
        return "".join(p.get("text", "") for p in parts)

    @classmethod
    def _delta(cls, event: dict) -> Optional[str]:
        return cls._text(event) or None
