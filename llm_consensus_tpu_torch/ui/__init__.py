"""The CLI's TTY output (a copy of ``llm_consensus_tpu/ui/``): the live
progress display and the static printers."""

from llm_consensus_tpu_torch.ui.progress import ModelState, ModelStatus, Progress
from llm_consensus_tpu_torch.ui.printers import (
    is_terminal,
    print_aggregate,
    print_consensus,
    print_error,
    print_header,
    print_model_response,
    print_phase,
    print_serve_banner,
    print_success,
    print_summary,
    print_throughput,
)

__all__ = [
    "ModelState",
    "ModelStatus",
    "Progress",
    "is_terminal",
    "print_aggregate",
    "print_consensus",
    "print_error",
    "print_header",
    "print_model_response",
    "print_phase",
    "print_serve_banner",
    "print_success",
    "print_summary",
    "print_throughput",
]
