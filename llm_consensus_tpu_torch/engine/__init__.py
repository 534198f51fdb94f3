"""The port's on-device inference engine and tokenizers."""

from llm_consensus_tpu_torch.engine.engine import Engine, GenerateResult, SamplingParams
from llm_consensus_tpu_torch.engine.speculative import (
    OracleDrafter, PromptLookupDrafter, SpecConfig, SpeculativeEngine)
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer, StreamDecoder, load_tokenizer

__all__ = [
    "ByteTokenizer", "Engine", "GenerateResult", "OracleDrafter", "PromptLookupDrafter",
    "SamplingParams", "SpecConfig", "SpeculativeEngine", "StreamDecoder", "load_tokenizer",
]
