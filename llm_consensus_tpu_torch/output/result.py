"""The JSON output contract of a consensus run (port of
``llm_consensus_tpu/output/result.py``): field order and names as the JAX
package writes them (prompt, responses, consensus, judge, then warnings,
failed_models, history, agreement, confidence), ``warnings``,
``failed_models`` and ``history`` omitted when empty, ``agreement`` and
``confidence`` omitted when None.
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
    # Conversation history (--continue, -i): earlier {prompt, consensus}
    # exchanges, oldest first.
    history: list[dict] = field(default_factory=list)
    # Panel agreement analysis (consensus/agreement.py): {score, level,
    # divergence}; None for fewer than two responses.
    agreement: "dict | None" = None
    # Judge-graded confidence in the consensus (--confidence):
    # {score: 0-100, controversy: [str]}.
    confidence: "dict | None" = None

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
        if self.history:
            out["history"] = self.history
        if self.agreement is not None:
            out["agreement"] = self.agreement
        if self.confidence is not None:
            out["confidence"] = self.confidence
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, ensure_ascii=False) + "\n"
