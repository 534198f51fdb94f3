"""Providers of the port: the abstraction, the registry and its remote
catalog, the ``gpu:`` device provider (providers/gpu.py) and the remote
HTTP providers (providers/openai.py, anthropic.py, google.py)."""

from llm_consensus_tpu_torch.providers.base import (
    Provider, ProviderFunc, Request, Response, StreamCallback)
from llm_consensus_tpu_torch.providers.registry import (
    REMOTE_MODELS, Registry, UnknownModelError, create_remote_provider, remote_registry)

__all__ = [
    "REMOTE_MODELS", "Provider", "ProviderFunc", "Registry", "Request", "Response",
    "StreamCallback", "UnknownModelError", "create_remote_provider", "remote_registry",
]
