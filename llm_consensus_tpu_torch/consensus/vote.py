"""Voting mode (``--vote``): panel models choose among predefined options
(a copy of ``llm_consensus_tpu/consensus/vote.py``).

Instead of a judge's synthesis, each panel model is asked to pick one of the
caller's options and the host tallies the votes. No judge model runs: the
consensus is the plurality winner, with the tally and each model's choice
summarized in the consensus text, so the result's JSON keeps its shape.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from llm_consensus_tpu_torch.providers import Response

VOTE_PROMPT = """\
{prompt}

Choose exactly ONE of the following options as your answer:
{option_lines}

Respond with the chosen option on the FIRST line, exactly as written above
(you may add brief reasoning on later lines).
"""


def render_vote_prompt(prompt: str, options: list[str]) -> str:
    option_lines = "\n".join(f"- {o}" for o in options)
    return VOTE_PROMPT.format(prompt=prompt, option_lines=option_lines)


def parse_vote(content: str, options: list[str]) -> Optional[str]:
    """The option a response chose, or None when it can't be determined.

    Precedence: an exact (case-insensitive) option on the first non-empty
    line; else the option whose LAST whole-word occurrence comes latest in
    the response — conclusions come last in prose ("While Python is
    popular, Go is the better fit" votes Go). A heuristic either way; the
    first-line format the prompt asks for is the reliable path.
    """
    lines = [ln.strip() for ln in content.splitlines() if ln.strip()]
    if lines:
        first = lines[0].strip().strip("-• ").rstrip(".").strip()
        for o in options:
            if first.lower() == o.lower():
                return o
    best: tuple[int, str] | None = None
    for o in options:
        last = None
        for m in re.finditer(rf"(?<!\w){re.escape(o)}(?!\w)", content, re.IGNORECASE):
            last = m.start()
        if last is not None and (best is None or last > best[0]):
            best = (last, o)
    return best[1] if best else None


@dataclass
class VoteResult:
    winner: Optional[str]
    counts: dict[str, int]
    by_model: dict[str, Optional[str]] = field(default_factory=dict)
    unparsed: list[str] = field(default_factory=list)  # model names

    def summary(self) -> str:
        """The consensus text for a vote run."""
        total = sum(self.counts.values())
        lines = []
        if self.winner is not None:
            lines.append(self.winner)
        else:
            lines.append("No winner: no response contained a recognizable vote.")
        lines.append("")
        lines.append(f"Votes ({total} counted):")
        for option, n in sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0])):
            voters = [m for m, v in self.by_model.items() if v == option]
            lines.append(f"- {option}: {n} ({', '.join(voters)})" if voters
                         else f"- {option}: {n}")
        for m in self.unparsed:
            lines.append(f"- (no vote parsed): {m}")
        return "\n".join(lines)


def tally_votes(responses: list[Response], options: list[str]) -> VoteResult:
    """Plurality winner over parsed votes; ties break by option order."""
    counts = {o: 0 for o in options}
    by_model: dict[str, Optional[str]] = {}
    unparsed: list[str] = []
    for resp in responses:
        choice = parse_vote(resp.content, options)
        by_model[resp.model] = choice
        if choice is None:
            unparsed.append(resp.model)
        else:
            counts[choice] += 1
    winner = None
    if any(counts.values()):
        best = max(counts.values())
        winner = next(o for o in options if counts[o] == best)
    return VoteResult(winner=winner, counts=counts, by_model=by_model,
                      unparsed=unparsed)
