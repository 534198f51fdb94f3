"""Thread-safe model-name → Provider registry and the remote catalog (a
copy of ``llm_consensus_tpu/providers/registry.py``).

:data:`REMOTE_MODELS` maps each remote API model to its provider kind,
:func:`create_remote_provider` builds the HTTP provider serving one, and
:func:`remote_registry` a whole panel-and-judge registry of them. The CLI
layers the ``gpu:`` scheme on top.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.providers.base import Provider

# Known remote models → provider kind (the JAX package's catalog).
REMOTE_MODELS: dict[str, str] = {
    "gpt-5.2-2025-12-11": "openai",
    "gpt-5.2-pro-2025-12-11": "openai",
    "claude-sonnet-4-5": "anthropic",
    "claude-haiku-4-5": "anthropic",
    "claude-opus-4-5": "anthropic",
    "gemini-3-pro-preview": "google",
}


def create_remote_provider(model: str, **retry) -> Provider:
    """The HTTP provider serving a :data:`REMOTE_MODELS` entry; ``retry``
    (``retries``, ``backoff``) goes to it. An unknown model raises
    ``ValueError``; a missing API key ``RuntimeError``."""
    kind = REMOTE_MODELS.get(model)
    if kind is None:
        raise ValueError(f"unknown remote model {model!r}; available: {sorted(REMOTE_MODELS)}")
    if kind == "openai":
        from llm_consensus_tpu_torch.providers.openai import OpenAIProvider as cls
    elif kind == "anthropic":
        from llm_consensus_tpu_torch.providers.anthropic import AnthropicProvider as cls
    else:
        from llm_consensus_tpu_torch.providers.google import GoogleProvider as cls
    return cls(**retry)


def remote_registry(models: list[str], judge: Optional[str], **retry) -> "Registry":
    """One remote provider per unique model, judge included (every name
    must be in :data:`REMOTE_MODELS`)."""
    registry = Registry()
    for model in dict.fromkeys(models + ([judge] if judge else [])):
        registry.register(model, create_remote_provider(model, **retry))
    return registry


class UnknownModelError(KeyError):
    """Raised by :meth:`Registry.get` for an unregistered model."""

    def __init__(self, model: str, available: list[str]):
        self.model = model
        self.available = available
        super().__init__(model)

    def __str__(self) -> str:
        return f"unknown model {self.model!r}; registered models: {self.available}"


class Registry:
    """Maps model names to the Provider serving them."""

    def __init__(self) -> None:
        self._lock = sanitizer.make_rlock("providers.registry")
        self._providers: dict[str, Provider] = {}

    def register(self, model: str, provider: Provider) -> None:
        with self._lock:
            self._providers[model] = provider

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._providers)

    def get(self, model: str) -> Provider:
        with self._lock:
            try:
                return self._providers[model]
            except KeyError:
                raise UnknownModelError(model, sorted(self._providers)) from None

    def __contains__(self, model: str) -> bool:
        with self._lock:
            return model in self._providers
