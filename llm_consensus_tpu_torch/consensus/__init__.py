from llm_consensus_tpu_torch.consensus.agreement import Agreement, score_agreement
from llm_consensus_tpu_torch.consensus.confidence import (
    Confidence, grade_confidence, parse_confidence, render_confidence_prompt)
from llm_consensus_tpu_torch.consensus.judge import (
    Judge, NoResponsesError, render_critique_prompt, render_judge_prompt, render_refine_prompt,
    render_response_block)
from llm_consensus_tpu_torch.consensus.overlap import (
    OverlapJudge, make_overlap_judge, overlap_enabled)
from llm_consensus_tpu_torch.consensus.vote import (
    VoteResult, parse_vote, render_vote_prompt, tally_votes)

__all__ = ["Agreement", "Confidence", "Judge", "NoResponsesError", "OverlapJudge",
           "VoteResult", "grade_confidence", "make_overlap_judge", "overlap_enabled",
           "parse_confidence", "parse_vote", "render_confidence_prompt",
           "render_critique_prompt", "render_judge_prompt", "render_refine_prompt",
           "render_response_block", "render_vote_prompt", "score_agreement", "tally_votes"]
