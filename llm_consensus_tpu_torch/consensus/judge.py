"""LLM-as-Judge consensus synthesis (port of ``llm_consensus_tpu/consensus/judge.py``).

  * The judge prompt embeds the user's original prompt plus every panel
    response, each introduced by the separator line
    ``--- Model: <model> | Provider: <provider> ---``; the template text is
    a copy of the JAX package's, byte for byte.
  * Empty response list → error.
  * Exactly one response → returned verbatim with no judge call, still
    invoking the stream callback once.
  * Otherwise a single streamed query against the judge's provider.

The refinement rounds of ``--rounds`` use the critique prompt (the panel's)
and the refine prompt (the judge's "user prompt"), both copies of the JAX
package's, byte for byte.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.providers import Provider, Request, Response, StreamCallback
from llm_consensus_tpu_torch.utils.context import Context

JUDGE_PROMPT_HEADER = """\
Role
You are a synthesis judge. Several AI models independently answered the same
user prompt; your job is to merge their answers into the single best response.

Inputs
User's original prompt:
{prompt}

Model responses:
"""

JUDGE_PROMPT_FOOTER = """\

Task
Write ONE final answer to the user's original prompt, synthesized from the
model responses above.

Guidelines
1) Honor the intent, scope, tone, and formatting implied by the original
   prompt.
2) Keep the claims that multiple responses agree on or that are best
   justified; when responses conflict, prefer the more specific, more
   logically sound, and safer position, qualifying briefly if real
   uncertainty remains.
3) Add connective material only where needed for completeness — never invent
   facts or pad the answer.

Output requirements
- Output ONLY the synthesized answer: no preamble, no meta-commentary, and no
  mention of the models, their disagreements, or the word "consensus".
- Do not quote or attribute individual model responses.
- Keep it coherent and non-redundant; use structure (headings, bullets, code
  blocks) when it serves the task.
"""


CRITIQUE_PROMPT = """\
{prompt}

A draft answer to the prompt above is shown below. Critique it — identify
errors, omissions, and concrete improvements — then provide your own
corrected and improved answer.

--- Draft answer ---
{draft}
"""


def render_critique_prompt(prompt: str, draft: str) -> str:
    """Panel prompt of a refinement round: the panel critiques the
    previous synthesis."""
    return CRITIQUE_PROMPT.format(prompt=prompt, draft=draft)


def render_refine_prompt(prompt: str, draft: str) -> str:
    """The "user prompt" a refinement round's judge sees: the original
    prompt plus the draft under revision (the critiques arrive as the
    panel responses through the normal judge template)."""
    return (
        f"{prompt}\n\n[Previous draft answer under revision]\n{draft}"
    )


def render_response_block(resp: Response) -> str:
    """One panel answer's block in the judge prompt: separator line + content."""
    return (
        f"\n--- Model: {resp.model} | Provider: {resp.provider} ---\n"
        f"{resp.content}\n"
    )


def render_judge_prompt(prompt: str, responses: list[Response]) -> str:
    """Render the judge prompt."""
    parts = [JUDGE_PROMPT_HEADER.format(prompt=prompt)]
    for resp in responses:
        parts.append(render_response_block(resp))
    parts.append(JUDGE_PROMPT_FOOTER)
    return "".join(parts)


class NoResponsesError(ValueError):
    """No responses to synthesize."""

    def __str__(self) -> str:
        return "no responses to synthesize"


class Judge:
    """Synthesizes consensus from multiple model responses."""

    def __init__(self, provider: Provider, model: str,
                 max_tokens: Optional[int] = None, priority: Optional[int] = None):
        self._provider = provider
        self._model = model
        self._max_tokens = max_tokens
        # The judge outranks panel work by default (HIGH); a run with an
        # explicit panel class passes the class one above it.
        self._priority = 0 if priority is None else priority
        # Set when the engine had to truncate the judge prompt (long panel
        # concatenation vs the judge's context window); the CLI surfaces
        # it as a run warning.
        self.last_truncated = False

    def synthesize_stream(
        self,
        ctx: Context,
        prompt: str,
        responses: list[Response],
        callback: Optional[StreamCallback],
    ) -> str:
        if not responses:
            raise NoResponsesError()
        self.last_truncated = False

        # Single response: no consensus needed, pass it through.
        if len(responses) == 1:
            if callback is not None:
                callback(responses[0].content)
            return responses[0].content

        judge_prompt = render_judge_prompt(prompt, responses)
        try:
            resp = self._provider.query_stream(
                ctx,
                Request(model=self._model, prompt=judge_prompt,
                        max_tokens=self._max_tokens, priority=self._priority),
                callback,
            )
        except Exception as err:
            raise RuntimeError(f"judge query failed: {err}") from err
        self.last_truncated = resp.truncated
        return resp.content
