"""Judge-graded confidence in the synthesized consensus (``--confidence``;
a copy of ``llm_consensus_tpu/consensus/confidence.py``).

After synthesis the judge rates its confidence in the consensus (0-100) and
lists the controversy points where the panel disagreed: the judge-graded
complement of the deterministic agreement score (``consensus/agreement.py``)
that every result carries.

The judge's reply is held to a strict line format, so parsing is
mechanical; a reply that does not follow it parses to a ``None`` score and
the CLI warns: a grading failure never fails the run.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from llm_consensus_tpu_torch.providers import Provider, Request, Response
from llm_consensus_tpu_torch.utils.context import Context

CONFIDENCE_PROMPT = """\
Role
You are a grading judge. Several AI models answered the same user prompt,
and a consensus answer was synthesized from their responses. Rate how
confident a reader should be in the consensus answer.

User's original prompt:
{prompt}

Model responses:
{responses}

Synthesized consensus answer:
{consensus}

Task
Output EXACTLY this format, nothing else:

CONFIDENCE: <integer 0-100>
CONTROVERSY:
- <one line per point where the model responses materially disagreed>

Rules: 100 means the responses agree and the consensus is well supported;
0 means they conflict so much the consensus is a guess. If there are no
material disagreements, output "CONTROVERSY: none" instead of the list.
"""


def render_confidence_prompt(
    prompt: str, responses: list[Response], consensus: str
) -> str:
    blocks = [
        f"--- Model: {r.model} | Provider: {r.provider} ---\n{r.content}"
        for r in responses
    ]
    return CONFIDENCE_PROMPT.format(
        prompt=prompt, responses="\n".join(blocks), consensus=consensus
    )


@dataclass
class Confidence:
    score: Optional[int]              # 0-100; None when unparseable
    controversy: list[str] = field(default_factory=list)
    raw: str = ""                     # judge's verbatim grading reply

    def to_dict(self) -> dict:
        out: dict = {"score": self.score}
        if self.controversy:
            out["controversy"] = self.controversy
        return out


_SCORE_RE = re.compile(r"CONFIDENCE:\s*(\d{1,3})", re.IGNORECASE)


def parse_confidence(content: str) -> Confidence:
    """Parse the strict grading format; tolerant of extra prose around it."""
    m = _SCORE_RE.search(content)
    score = None
    if m:
        score = max(0, min(100, int(m.group(1))))
    controversy: list[str] = []
    in_list = False
    for line in content.splitlines():
        stripped = line.strip()
        if re.match(r"CONTROVERSY:", stripped, re.IGNORECASE):
            in_list = True
            tail = stripped.split(":", 1)[1].strip()
            if tail and tail.lower() != "none":
                controversy.append(tail)
            continue
        if in_list:
            if stripped.startswith(("-", "*")):
                point = stripped.lstrip("-* ").strip()
                if point:
                    controversy.append(point)
            elif stripped:
                in_list = False  # list ended at the first non-bullet line
    return Confidence(score=score, controversy=controversy, raw=content)


def grade_confidence(
    ctx: Context,
    provider: Provider,
    judge_model: str,
    prompt: str,
    responses: list[Response],
    consensus: str,
    max_tokens: Optional[int] = None,
) -> Confidence:
    """One judge query rating the consensus. Raises only on provider
    errors; a malformed reply parses to score=None (caller warns)."""
    req = Request(
        model=judge_model,
        prompt=render_confidence_prompt(prompt, responses, consensus),
        max_tokens=max_tokens,
    )
    resp = provider.query(ctx, req)
    return parse_confidence(resp.content)
