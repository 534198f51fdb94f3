"""Thread-safe model-name → Provider registry (a copy of the registry half
of ``llm_consensus_tpu/providers/registry.py``; the port serves only the
``gpu:`` device provider)."""

from __future__ import annotations

import threading

from llm_consensus_tpu_torch.providers.base import Provider


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
        self._lock = threading.RLock()
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
