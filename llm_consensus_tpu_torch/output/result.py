"""The JSON output contract of a consensus run (port of
``llm_consensus_tpu/output/result.py``): field order and names as the JAX
package writes them, ``warnings`` and ``failed_models`` omitted when empty,
``agreement`` (the panel's, scored on every run) omitted when None. The
JAX package's other extension fields (history, confidence) belong to CLI
flags the port does not have yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from llm_consensus_tpu_torch.providers import Response


@dataclass
class Result:
    prompt: str
    responses: list[Response]
    consensus: str
    judge: str
    warnings: list[str] = field(default_factory=list)
    failed_models: list[str] = field(default_factory=list)
    # Panel agreement analysis (consensus/agreement.py): {score, level,
    # divergence}; None for fewer than two responses.
    agreement: "dict | None" = None

    def to_dict(self) -> dict:
        out = {
            "prompt": self.prompt,
            "responses": [r.to_dict() for r in self.responses],
            "consensus": self.consensus,
            "judge": self.judge,
        }
        if self.warnings:
            out["warnings"] = self.warnings
        if self.failed_models:
            out["failed_models"] = self.failed_models
        if self.agreement is not None:
            out["agreement"] = self.agreement
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, ensure_ascii=False) + "\n"
