"""Judge prefill overlapped with the panel's decode (a copy of
``llm_consensus_tpu/consensus/overlap.py``).

The classic synthesis (consensus/judge.py) renders the judge prompt after
the last panel answer lands and only then prefills all of it. Here the
prompt streams into the judge engine as it becomes known:

  * the first panel answer opens a :class:`PrefillSession` on the judge
    engine and appends the prompt header;
  * each panel answer appends, through the runner's
    ``Callbacks.on_model_response`` hook, in ARRIVAL order, which is
    recorded and becomes the judge prompt's order (the runner's responses
    list has the same completion order);
  * at synthesis only the footer and the last partial chunk remain to
    prefill.

The classic path's contract holds: the separator block is the shared
``render_response_block``, one response is passed through without a judge
query, none raises, and whatever the session cannot honor (a prompt over
the truncation threshold, a failed append, a refine round's other prompt,
responses the hook never saw or saw in another order) falls back to the
classic ``Judge`` over the same provider. It engages only under
``--judge-overlap`` / ``LLMC_JUDGE_OVERLAP`` with a judge whose provider
hands out an engine (``_engine_for``: the ``gpu:`` provider, not the HTTP
ones).

One departure from the JAX module: a fault of the card is not an
optimization that failed. A ``KernelBuildError`` or ``KernelLaunchError``,
or any ``torch.cuda`` error but ``OutOfMemoryError``, raised while the
session appends is stored and raised again by ``synthesize_stream`` (the
runner swallows hook exceptions), and one raised by the session's
generate propagates; neither becomes the classic fallback.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.consensus.judge import (
    JUDGE_PROMPT_FOOTER, JUDGE_PROMPT_HEADER, Judge, NoResponsesError, render_response_block)
from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError
from llm_consensus_tpu_torch.providers import Provider, Response, StreamCallback
from llm_consensus_tpu_torch.utils.context import Cancelled, Context, DeadlineExceeded


# torch's types for an error the CUDA runtime returned (the older torch
# raised a RuntimeError whose text starts "CUDA error").
_CUDA_ERRORS = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                 getattr(torch.cuda, "CudaError", None)) if t is not None)


def device_fault(err: BaseException) -> bool:
    """Whether ``err`` is a fault of the card that no fallback may hide: a
    kernel that failed to build or launch, or a CUDA error other than
    running out of memory."""
    if isinstance(err, (KernelBuildError, KernelLaunchError)):
        return True
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return False
    return isinstance(err, _CUDA_ERRORS) or str(err).startswith("CUDA error")


def overlap_enabled(flag: Optional[bool] = None) -> bool:
    """The judge-overlap gate: an explicit flag wins, else
    ``LLMC_JUDGE_OVERLAP`` (off when unset)."""
    if flag is not None:
        return flag
    from llm_consensus_tpu_torch.utils.knobs import judge_overlap

    return judge_overlap()


def make_overlap_judge(provider: Provider, model: str, prompt: str,
                       max_tokens: Optional[int] = None,
                       enabled: Optional[bool] = None,
                       priority: Optional[int] = None,
                       trace_id: Optional[str] = None) -> "Optional[OverlapJudge]":
    """An :class:`OverlapJudge` when overlap is enabled and ``provider`` can
    hand out an engine for ``model``, else None (the caller uses the
    classic Judge and wires no hook). The engine resolves on the first
    panel answer, so a judge engine build overlaps the panel's decode."""
    if not overlap_enabled(enabled):
        return None
    if not hasattr(provider, "_engine_for"):
        return None  # HTTP providers: the classic path
    return OverlapJudge(provider, model, prompt, max_tokens=max_tokens, priority=priority,
                        trace_id=trace_id)


class OverlapJudge:
    """A judge with the classic ``Judge``'s ``synthesize_stream``, fed
    incrementally by :meth:`on_response` as panel answers arrive."""

    def __init__(self, provider, model: str, prompt: str, max_tokens: Optional[int] = None,
                 priority: Optional[int] = None, trace_id: Optional[str] = None):
        self._provider = provider
        self._model = model
        self._prompt = prompt
        self._max_tokens = max_tokens
        self._trace = trace_id  # the classic fallback's engine hop carries it
        self._priority = priority  # the classic fallback's class (None: the Judge's)
        self._lock = sanitizer.make_lock("consensus.overlap")
        self._engine = None
        self._session = None
        self._streamed: list[Response] = []  # arrival order
        self._failed = False
        self._fault: Optional[BaseException] = None  # a card fault, raised at synthesis
        self.fallbacks = 0  # syntheses that took the classic path
        self.prefilled = 0  # tokens prefilled early at the last synthesis
        self.last_truncated = False  # the classic Judge's truncation surface
        self._obs = obs.recorder()

    @property
    def model(self) -> str:
        return self._model

    @property
    def arrival_order(self) -> list[Response]:
        """The responses streamed so far, in the order the judge prompt
        is built with."""
        with self._lock:
            return list(self._streamed)

    def _max_new(self) -> int:
        if self._max_tokens is not None:
            return self._max_tokens
        from llm_consensus_tpu_torch.providers.gpu import DEFAULT_MAX_NEW_TOKENS

        return DEFAULT_MAX_NEW_TOKENS

    def _open_session_locked(self) -> None:
        engine = self._provider._engine_for(self._model)
        if not getattr(engine, "prefill_chunk", 0):
            raise RuntimeError("judge overlap requires chunked prefill on the judge engine")
        self._engine = engine
        self._session = engine.prefill_session()
        self._session.append_text(JUDGE_PROMPT_HEADER.format(prompt=self._prompt))

    def on_response(self, resp: Response) -> None:
        """Append one panel answer to the judge's growing cache as it
        arrives (wired as ``Callbacks.on_model_response``); thread-safe.
        A failure marks the shim broken, and ``synthesize_stream`` falls
        back to the classic path, or raises it when the card is at
        fault."""
        t0_obs = self._obs.now() if self._obs is not None else 0
        with self._lock:
            if self._failed:
                return
            try:
                if self._session is None:
                    self._open_session_locked()
                n = self._session.append_text(render_response_block(resp))
                self._streamed.append(resp)
                if self._session.overflowed:
                    # Past the context window: the classic path would
                    # middle-out truncate, which a written cache cannot.
                    self._failed = True
            except Exception as err:  # noqa: BLE001 — overlap is an optimization
                self._failed = True
                if device_fault(err):
                    self._fault = err
                return
        if self._obs is not None:
            self._obs.complete("judge_overlap", t0_obs, tid="judge", model=resp.model, tokens=n)
            self._obs.count("judge.overlap_prefill_tokens", n)

    def _abandon_session(self) -> None:
        with self._lock:
            session, self._session = self._session, None
        if session is not None:
            session.close()  # the cache's memory; the engine stays warm

    def _fallback_classic(self, ctx: Context, prompt: str, responses: list[Response],
                          callback: Optional[StreamCallback]) -> str:
        """The classic Judge over the same provider (middle-out truncation
        and the provider's retry ladder included), the session abandoned."""
        self._abandon_session()
        self.fallbacks += 1
        classic = Judge(self._provider, self._model, max_tokens=self._max_tokens,
                        priority=self._priority, trace_id=self._trace)
        text = classic.synthesize_stream(ctx, prompt, responses, callback)
        self.last_truncated = classic.last_truncated
        return text

    def synthesize_stream(self, ctx: Context, prompt: str, responses: list[Response],
                          callback: Optional[StreamCallback]) -> str:
        with self._lock:
            fault = self._fault
        if fault is not None:
            self._abandon_session()
            raise RuntimeError(f"judge query failed: {fault}") from fault
        if not responses:
            raise NoResponsesError()
        self.last_truncated = False
        self.prefilled = 0

        # One response: passed through, the session abandoned unread.
        if len(responses) == 1:
            self._abandon_session()
            if callback is not None:
                callback(responses[0].content)
            return responses[0].content

        with self._lock:
            session, engine = self._session, self._engine
            # EXACT order, not set equality: the hook fires outside the
            # runner's lock, so two near-simultaneous answers can stream in
            # the other order than result.responses holds them.
            usable = (
                not self._failed
                and session is not None
                and not session.closed
                and not session.overflowed
                and prompt == self._prompt
                and [id(r) for r in self._streamed] == [id(r) for r in responses]
            )
        if not usable:
            return self._fallback_classic(ctx, prompt, responses, callback)

        from llm_consensus_tpu_torch.engine import SamplingParams

        max_new = self._max_new()
        n_footer = len(engine.tokenizer.encode(JUDGE_PROMPT_FOOTER))
        if session.tokens + n_footer > engine._prompt_budget(max_new):
            # Over the truncation threshold: the classic path would
            # middle-out truncate; a written cache cannot.
            return self._fallback_classic(ctx, prompt, responses, callback)

        t0 = time.monotonic()
        t0_obs = self._obs.now() if self._obs is not None else 0
        self.prefilled = session.prefilled
        first_chunk_t: list = [None]

        def on_text(chunk: str) -> None:
            if first_chunk_t[0] is None:
                first_chunk_t[0] = time.monotonic()
            if callback is not None:
                callback(chunk)

        try:
            session.append_text(JUDGE_PROMPT_FOOTER)
            result = session.generate(SamplingParams(max_new_tokens=max_new, temperature=0.0),
                                      ctx, on_text=on_text)
        except (Cancelled, DeadlineExceeded):
            raise  # a doomed request must not pay a classic retry
        except Exception as err:
            # A transient failure gets the classic path's grace (its retry
            # ladder), unless text already reached the caller or the card
            # is at fault.
            if first_chunk_t[0] is not None or device_fault(err):
                raise RuntimeError(f"judge query failed: {err}") from err
            return self._fallback_classic(ctx, prompt, responses, callback)
        finally:
            self._abandon_session()
        if result.finish_reason in ("deadline", "cancelled"):
            ctx.raise_if_done()  # a timed-out judge is a failed judge
        # The run aggregates the provider's query path would have booked.
        stats = getattr(self._provider, "stats", None)
        plock = getattr(self._provider, "_lock", None)
        if stats is not None and plock is not None:
            with plock:
                stats["tokens"] = stats.get("tokens", 0) + len(result.token_ids)
                stats["runs"] = stats.get("runs", 0) + 1
        if self._obs is not None:
            ttft = (first_chunk_t[0] or time.monotonic()) - t0
            self._obs.complete("judge_overlap_synthesize", t0_obs, tid="judge",
                               prefilled_early=self.prefilled,
                               prompt_tokens=result.prompt_tokens,
                               ttft_ms=round(ttft * 1000, 1))
            self._obs.count("judge.ttft_s", ttft)
            self._obs.count("judge.ttft_runs", 1)
            if result.decode_s > 0:
                self._obs.count("decode_tokens", result.decode_tokens)
                self._obs.count("decode_s", result.decode_s)
        return result.text
