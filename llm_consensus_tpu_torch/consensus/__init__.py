from llm_consensus_tpu_torch.consensus.agreement import Agreement, score_agreement
from llm_consensus_tpu_torch.consensus.judge import (
    Judge, NoResponsesError, render_judge_prompt, render_response_block)

__all__ = ["Agreement", "Judge", "NoResponsesError", "render_judge_prompt",
           "render_response_block", "score_agreement"]
