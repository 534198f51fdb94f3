"""Agreement scoring: how much the panel aligned (a copy of
``llm_consensus_tpu/consensus/agreement.py``).

Deterministic, host-side: no judge call, no model in the loop. Agreement
between two answers is token-level similarity (difflib ratio over
whitespace tokens — order-aware, so reordered-but-identical claims score
high but not 1.0); the panel score is the mean over pairs, and each
model's ``divergence`` is 1 − its mean similarity to the others, which
makes the outlier visible. Surfaced in the Result JSON (``agreement``,
omitted when fewer than two responses) and the CLI summary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from difflib import SequenceMatcher

from llm_consensus_tpu_torch.providers import Response


# SequenceMatcher is O(n²) worst-case; comparing only the first N tokens
# bounds the pairwise pass (panels of long answers would otherwise stall
# the run for seconds between fan-out and output) at negligible accuracy
# cost — answers that agree in their first 400 tokens agree.
_MAX_TOKENS = 400


def _similarity(a: str, b: str) -> float:
    """Order-aware token similarity in [0, 1]."""
    ta, tb = a.split()[:_MAX_TOKENS], b.split()[:_MAX_TOKENS]
    if not ta and not tb:
        return 1.0
    return SequenceMatcher(a=ta, b=tb, autojunk=False).ratio()


@dataclass
class Agreement:
    score: float                      # mean pairwise similarity, [0, 1]
    level: str                        # "high" | "moderate" | "low"
    divergence: dict[str, float] = field(default_factory=dict)  # per model

    def to_dict(self) -> dict:
        return {
            "score": round(self.score, 3),
            "level": self.level,
            "divergence": {m: round(d, 3) for m, d in self.divergence.items()},
        }


def _level(score: float) -> str:
    if score >= 0.66:
        return "high"
    if score >= 0.33:
        return "moderate"
    return "low"


def score_agreement(responses: list[Response]) -> "Agreement | None":
    """Panel agreement, or None when there's nothing to compare."""
    if len(responses) < 2:
        return None
    n = len(responses)
    sims = [[0.0] * n for _ in range(n)]
    total, pairs = 0.0, 0
    for i in range(n):
        for j in range(i + 1, n):
            s = _similarity(responses[i].content, responses[j].content)
            sims[i][j] = sims[j][i] = s
            total += s
            pairs += 1
    score = total / pairs
    divergence = {
        responses[i].model: 1.0 - sum(sims[i]) / (n - 1) for i in range(n)
    }
    return Agreement(score=score, level=_level(score), divergence=divergence)
