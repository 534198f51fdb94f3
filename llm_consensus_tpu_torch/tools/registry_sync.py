"""model-registry-sync — build a normalized model catalog from many sources.

The port's copy of the JAX package's tool (``llm_consensus_tpu/tools/
registry_sync.py``), which follows the reference's standalone
``cmd/model-registry-sync`` binary: it fetches the OpenAI model list
(``GET /v1/models``) and the OpenRouter list (``GET /api/v1/models``),
normalizes both into ``ModelRecord{Source, ID, Name, ContextLength,
Pricing, Raw}``, stable-sorts by ``(source, id)``, and writes JSON to
stdout or ``--out``. A source failing is non-fatal: the records from
healthy sources are still written and the failures are warned at the end.

The ``local`` source enumerates the port's on-device catalog (its
models/config.py presets) under the ``gpu:<preset>`` names the port's CLI
accepts (the JAX tool writes ``tpu:<preset>``), with ``context_length``
taken from the preset's ``max_seq_len`` and parameter counts in ``raw``.
``providers/models/models.json`` is this source's output, shipped.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

DEFAULT_OPENAI_BASE = "https://api.openai.com/v1"
DEFAULT_OPENROUTER_BASE = "https://openrouter.ai/api/v1"
DEFAULT_TIMEOUT_S = 30.0


@dataclass
class ModelRecord:
    """One catalog entry, normalized across sources.

    Field set parity: model-registry-sync/main.go:18-25 (Source, ID, Name,
    ContextLength, Pricing, Raw).
    """

    source: str
    id: str
    name: str = ""
    context_length: Optional[int] = None
    pricing: Optional[dict] = None
    raw: Optional[dict] = field(default=None, repr=False)

    def to_json(self, include_raw: bool) -> dict:
        out: dict = {"source": self.source, "id": self.id}
        if self.name:
            out["name"] = self.name
        if self.context_length is not None:
            out["context_length"] = self.context_length
        if self.pricing is not None:
            out["pricing"] = self.pricing
        if include_raw and self.raw is not None:
            out["raw"] = self.raw
        return out


class SourceError(RuntimeError):
    """A catalog source failed entirely (network, auth, bad payload)."""


def _http_get_json(url: str, headers: dict[str, str], timeout: float) -> dict:
    req = urllib.request.Request(url, headers=headers, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
    except urllib.error.HTTPError as e:
        detail = e.read()[:500].decode("utf-8", "replace")
        raise SourceError(f"GET {url}: status {e.code}: {detail}") from e
    except (urllib.error.URLError, OSError) as e:
        raise SourceError(f"GET {url}: {e}") from e
    try:
        payload = json.loads(body)
    except json.JSONDecodeError as e:
        raise SourceError(f"GET {url}: invalid JSON: {e}") from e
    if not isinstance(payload, dict):
        raise SourceError(f"GET {url}: expected JSON object, got {type(payload).__name__}")
    return payload


def _data_items(payload: dict, url: str) -> list[dict]:
    """The ``data`` array of a catalog payload, dict entries only.

    Feeds occasionally ship junk entries; non-dict items are dropped rather
    than crashing so one odd record can't take the whole source down."""
    data = payload.get("data", [])
    if not isinstance(data, list):
        raise SourceError(f"{url}: 'data' is not a list")
    return [item for item in data if isinstance(item, dict)]


def _clean_str(value) -> str:
    """Feed string field → str; null/non-string junk → "" (record dropped
    or field blanked, never the literal "None")."""
    return value if isinstance(value, str) else ""


def _clean_int(value) -> Optional[int]:
    """Feed numeric field → int, or None for junk — including the
    ``Infinity``/``NaN`` literals Python's json parser accepts, which would
    otherwise raise past the per-source error isolation in sync()."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return int(value)


def fetch_openai_models(
    base_url: str = DEFAULT_OPENAI_BASE,
    api_key: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> list[ModelRecord]:
    """OpenAI ``GET {base}/models`` → records. Requires an API key
    (env ``OPENAI_API_KEY`` unless passed), as main.go:130-140."""
    key = api_key or os.environ.get("OPENAI_API_KEY", "")
    if not key:
        raise SourceError("openai: OPENAI_API_KEY not set")
    payload = _http_get_json(
        f"{base_url.rstrip('/')}/models",
        {"Authorization": f"Bearer {key}"},
        timeout,
    )
    records = []
    for item in _data_items(payload, url="openai"):
        mid = _clean_str(item.get("id"))
        if not mid:
            continue
        records.append(ModelRecord(source="openai", id=mid, raw=item))
    return records


def fetch_openrouter_models(
    base_url: str = DEFAULT_OPENROUTER_BASE,
    api_key: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> list[ModelRecord]:
    """OpenRouter ``GET {base}/models`` → records with context_length and
    per-token pricing (main.go:172-216). The key is optional."""
    key = api_key or os.environ.get("OPENROUTER_API_KEY", "")
    headers = {"Authorization": f"Bearer {key}"} if key else {}
    payload = _http_get_json(f"{base_url.rstrip('/')}/models", headers, timeout)
    records = []
    for item in _data_items(payload, url="openrouter"):
        mid = _clean_str(item.get("id"))
        if not mid:
            continue
        ctx = item.get("context_length")
        pricing = item.get("pricing")
        records.append(
            ModelRecord(
                source="openrouter",
                id=mid,
                name=_clean_str(item.get("name")),
                context_length=_clean_int(ctx),
                pricing={k: str(v) for k, v in pricing.items()}
                if isinstance(pricing, dict)
                else None,
                raw=item,
            )
        )
    return records


def fetch_local_models() -> list[ModelRecord]:
    """The on-device catalog: every model preset this framework can run.

    No network involved — this is the source of truth for the
    ``gpu:<model>`` names the port's CLI accepts, the on-device analog of
    the remote catalogs.
    """
    from llm_consensus_tpu_torch.models import MODEL_PRESETS

    records = []
    for name, cfg in MODEL_PRESETS.items():
        records.append(
            ModelRecord(
                source="local",
                id=f"gpu:{name}",
                name=name,
                context_length=cfg.max_seq_len,
                raw={
                    "family": cfg.family,
                    "n_params": cfg.n_params(),
                    "n_layers": cfg.n_layers,
                    "d_model": cfg.d_model,
                    "moe": cfg.is_moe,
                },
            )
        )
    return records


def sync(
    sources: dict[str, Callable[[], list[ModelRecord]]],
) -> tuple[list[ModelRecord], list[str]]:
    """Run every enabled source; collect records and per-source warnings.

    Partial failure is non-fatal (main.go:121-127): a failing source adds a
    warning and the rest proceed. Output is stable-sorted by (source, id)
    (main.go:100-105).
    """
    records: list[ModelRecord] = []
    warnings: list[str] = []
    for name, fetch in sources.items():
        try:
            records.extend(fetch())
        except SourceError as e:
            warnings.append(f"{name}: {e}")
    records.sort(key=lambda r: (r.source, r.id))
    return records, warnings


def render(records: list[ModelRecord], include_raw: bool) -> str:
    return json.dumps(
        [r.to_json(include_raw) for r in records], indent=2, ensure_ascii=False
    )


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="model-registry-sync",
        description="Fetch model catalogs and write a normalized JSON registry.",
    )
    p.add_argument("--out", default="", help="output path (default: stdout)")
    p.add_argument(
        "--raw", action="store_true", help="include each source's raw payload"
    )
    p.add_argument(
        "--openai",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="include the OpenAI source (needs OPENAI_API_KEY)",
    )
    p.add_argument(
        "--openrouter",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="include the OpenRouter source",
    )
    p.add_argument(
        "--local",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="include the on-device model catalog",
    )
    p.add_argument(
        "--timeout", type=float, default=DEFAULT_TIMEOUT_S, help="per-request timeout (s)"
    )
    p.add_argument("--openai-base-url", default=DEFAULT_OPENAI_BASE, help=argparse.SUPPRESS)
    p.add_argument(
        "--openrouter-base-url", default=DEFAULT_OPENROUTER_BASE, help=argparse.SUPPRESS
    )
    args = p.parse_args(argv)

    sources: dict[str, Callable[[], list[ModelRecord]]] = {}
    if args.local:
        sources["local"] = fetch_local_models
    if args.openai:
        sources["openai"] = lambda: fetch_openai_models(
            base_url=args.openai_base_url, timeout=args.timeout
        )
    if args.openrouter:
        sources["openrouter"] = lambda: fetch_openrouter_models(
            base_url=args.openrouter_base_url, timeout=args.timeout
        )
    if not sources:
        print("error: no sources enabled", file=sys.stderr)
        return 1

    records, warnings = sync(sources)
    text = render(records, include_raw=args.raw)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)

    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    # All sources down and nothing to show → hard failure; any healthy
    # source keeps the exit clean (reference: warn-and-continue).
    if not records and warnings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
