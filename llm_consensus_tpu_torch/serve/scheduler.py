"""Run sessions: one consensus run per admitted request, shared engines (a
copy of ``llm_consensus_tpu/serve/scheduler.py``).

The CLI's run lifecycle (cli/main.py::_run) is process-scoped — one
prompt, one progress UI, one exit. Serving needs the same panel → judge
pipeline but *per request*, many at once, with no UI and no process
lifecycle: that is :class:`Scheduler`. Each :meth:`execute` gives the
request

  * its own :class:`~llm_consensus_tpu_torch.utils.context.Context` (deadline =
    the request's timeout, child of the gateway's root so drain/shutdown
    cancels stragglers),
  * its own collision-free run id + ``data/<run-id>/`` persistence
    (output/persist.reserve_run_dir — wall-clock ids collide under
    concurrent runs, reserved dirs cannot),
  * headless streaming via an ``emit(kind, model, text)`` callback
    (``kind`` is ``"model_chunk"`` or ``"judge_chunk"``) instead of the
    CLI's Progress UI,

while every request shares the warm engines behind the registry's
providers — the whole point of a resident service: compiled programs and
weights stay on the chips, requests multiplex onto them through the
continuous batcher.

Concurrency: one :class:`~llm_consensus_tpu_torch.runner.Runner` is built per
run (construction is two bound lookups — cheap) with that run's callbacks,
so no callback state is shared between concurrent runs. Persistence failures are non-fatal, exactly like the CLI's aux
writes: a run that produced its answer must not fail because a disk
write did.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable, Optional

from llm_consensus_tpu_torch import output as output_mod
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.consensus import Judge, score_agreement
from llm_consensus_tpu_torch.output.persist import reserve_run_dir, save_file
from llm_consensus_tpu_torch.providers import Registry
from llm_consensus_tpu_torch.runner import Callbacks, Runner
from llm_consensus_tpu_torch.runner.runner import DEFAULT_STALL_GRACE_S
from llm_consensus_tpu_torch.utils.context import Context

# emit(kind, model, text): kind is "model_chunk" | "judge_chunk".
EmitFn = Callable[[str, str, str], None]


@dataclass
class ServeRequest:
    """One validated consensus request (the gateway parses JSON into this)."""

    prompt: str
    models: list[str]
    judge: str
    system: Optional[str] = None
    max_tokens: Optional[int] = None
    timeout: float = 120.0
    stream: bool = False
    # Priority class (pressure/priority.py): explicit "priority" field
    # or deadline-derived at parse time. Orders admission dequeue,
    # scales shed Retry-After, and selects preemption victims on the
    # engine tier. NOT part of the cache/coalescing key: priority
    # changes WHEN a request runs, never what it computes.
    priority: int = 1
    # Trace id (obs/live.py): the caller's X-LLMC-Trace or one minted by
    # the gateway, recorded on the run's spans and returned in the done
    # envelope. NOT part of the cache key — identity is what a request
    # computes, not its id.
    trace_id: Optional[str] = None
    # A migrated stream's resume payloads, model name → journal snapshot
    # (serve/elastic.py), from the record a failover re-submission claims.
    # NOT part of the cache key: a resumed stream computes the same answer.
    resume: Optional[dict] = None

    def cache_fields(self) -> dict:
        """The identity fields the cache key covers (serve/cache.py)."""
        return {
            "models": self.models,
            "judge": self.judge,
            "prompt": self.prompt,
            "system": self.system,
            "max_tokens": self.max_tokens,
        }


@dataclass
class RunSession:
    """One request's identity: run id, persistence dir, context."""

    run_id: str
    run_dir: str  # "" when persistence is disabled
    ctx: Context


class Scheduler:
    """Executes consensus runs over a shared registry of warm providers."""

    def __init__(
        self,
        registry: Registry,
        *,
        data_dir: str = "data",
        save: bool = True,
        root_ctx: Optional[Context] = None,
        live=None,
        judge_overlap: bool = False,
        stall_grace: float = DEFAULT_STALL_GRACE_S,
    ):
        self._registry = registry
        self._data_dir = data_dir
        self._save = save
        # All request contexts derive from this root: cancelling it (hard
        # shutdown) cancels every in-flight run cooperatively.
        self._root = root_ctx if root_ctx is not None else Context.background()
        self._lock = sanitizer.make_lock("serve.scheduler")
        # Judge prefill overlap (``--judge-overlap``): the flag, passed in.
        self._judge_overlap = bool(judge_overlap)
        # The runners' watchdog grace (LLMC_STALL_GRACE), passed in.
        self._stall_grace = stall_grace
        self.runs_executed = 0
        from llm_consensus_tpu_torch import obs

        self._obs = obs.recorder()
        # Live plane: judge-synthesis wall histogram (/metricsz) + run
        # spans in the always-on flight recorder ring. ``live`` override
        # keeps multi-gateway tests per-replica; production binds the
        # process singleton.
        self._live = live if live is not None else obs.live.metrics()
        self._bb = obs.blackbox.ring()

    # -- sessions ------------------------------------------------------------

    def request_ctx(self, req: ServeRequest) -> Context:
        """The request's own deadline context, child of the gateway root.

        Created before admission so time spent queued counts against the
        request's budget (a client that waited its whole deadline out in
        the queue gets an error, not a doomed run)."""
        return self._root.with_timeout(req.timeout)

    def open_session(
        self, req: ServeRequest, ctx: Optional[Context] = None
    ) -> RunSession:
        """Reserve the request's run id/dir; adopt ``ctx`` or derive one.

        Called after admission: rejected requests never reserve a dir."""
        if ctx is None:
            ctx = self.request_ctx(req)
        if not self._save:
            from llm_consensus_tpu_torch.output.persist import generate_run_id

            return RunSession(run_id=generate_run_id(), run_dir="", ctx=ctx)
        run_id, run_dir = reserve_run_dir(self._data_dir)
        # Manifest BEFORE execution, mirroring the CLI's crash-resume
        # journal (cli/main.py::write_run_manifest): run.json is the sole
        # authority the flywheel corpus scanner trusts — a data/ dir
        # without one is not a run (flywheel/corpus.py).
        save_file(run_dir, "run.json", json.dumps({
            "prompt": req.prompt,
            "models": list(req.models),
            "judge": req.judge,
            "system": req.system,
            "max_tokens": req.max_tokens,
            "timeout": req.timeout,
            "source": "serve",
        }, indent=2))
        return RunSession(run_id=run_id, run_dir=run_dir, ctx=ctx)

    def cancel_all(self) -> None:
        """Hard-cancel every in-flight run (post-drain-timeout shutdown)."""
        self._root.cancel()

    # -- execution -----------------------------------------------------------

    def execute(
        self,
        session: RunSession,
        req: ServeRequest,
        emit: Optional[EmitFn] = None,
    ) -> output_mod.Result:
        """Run panel fan-out + judge synthesis for one request.

        Streams through ``emit``; persists into the session's run dir;
        returns the finished Result. Raises on total failure (all panel
        models failed, judge failed, deadline expired)."""
        ctx = session.ctx
        t0_run = time.monotonic_ns()
        try:
            runner = Runner(
                self._registry,
                req.timeout,
                max_tokens=req.max_tokens,
                system=req.system or None,
                priority=req.priority,
                stall_grace=self._stall_grace,
                trace_id=req.trace_id,
                resume=req.resume,
            )
            # Judge prefill overlap (consensus/overlap.py): when enabled
            # and the judge is an on-device engine, panel answers prefill
            # into the judge's growing KV as they arrive, so synthesis
            # TTFT drops by nearly the whole judge-prompt prefill. The
            # shim is per-request (its session is single-use) and falls
            # back to the classic Judge internally on any condition it
            # cannot honor.
            overlap = None
            try:
                from llm_consensus_tpu_torch.consensus import make_overlap_judge

                overlap = make_overlap_judge(
                    self._registry.get(req.judge), req.judge, req.prompt,
                    max_tokens=req.max_tokens,
                    enabled=self._judge_overlap,
                    priority=max(0, req.priority - 1),
                    trace_id=req.trace_id,
                )
            except Exception:  # noqa: BLE001 — unknown judge errors below
                overlap = None
            callbacks = None
            if emit is not None or overlap is not None:
                callbacks = Callbacks(
                    on_model_stream=(
                        (lambda m, c: emit("model_chunk", m, c))
                        if emit is not None else None
                    ),
                    on_model_response=(
                        overlap.on_response if overlap is not None else None
                    ),
                )
            if callbacks is not None:
                runner.with_callbacks(callbacks)
            result = runner.run(ctx, list(req.models), req.prompt)

            agreement = score_agreement(result.responses)
            judge_provider = self._registry.get(req.judge)
            # Judge work outranks this request's own panel class by one
            # step (floored at HIGH): the judge serializes the run, so
            # on a contended engine its stream must not queue behind
            # other runs' panel streams of the same class.
            judge = overlap if overlap is not None else Judge(
                judge_provider, req.judge, max_tokens=req.max_tokens,
                priority=max(0, req.priority - 1),
                trace_id=req.trace_id,
            )
            judge_cb = None
            if emit is not None:
                judge_cb = lambda c: emit("judge_chunk", req.judge, c)  # noqa: E731
            t0_judge = time.monotonic()
            consensus = judge.synthesize_stream(
                ctx, req.prompt, result.responses, judge_cb
            )
            if self._live is not None:
                from llm_consensus_tpu_torch.obs.live import class_label

                # Judge synthesis wall for the /metricsz histogram —
                # labeled with the JUDGE's class (one step above the
                # request's own panel class, the same derivation the
                # Judge itself runs under).
                self._live.observe(
                    "judge_synthesis", time.monotonic() - t0_judge,
                    outcome="ok",
                    **{"class": class_label(max(0, req.priority - 1))},
                )
            if judge.last_truncated:
                result.warnings.append(
                    f"{req.judge}: judge prompt truncated to fit context window"
                )

            out = output_mod.Result(
                prompt=req.prompt,
                responses=result.responses,
                consensus=consensus,
                judge=req.judge,
                warnings=result.warnings,
                failed_models=result.failed_models,
                agreement=agreement.to_dict() if agreement else None,
            )
            with self._lock:
                self.runs_executed += 1
            if self._obs is not None:
                self._obs.count("serve.runs")
                self._obs.complete(
                    "consensus_run", t0_run, tid="serve",
                    trace=req.trace_id, run_id=session.run_id,
                )
            if self._bb is not None:
                self._bb.complete(
                    "consensus_run", t0_run, tid="serve",
                    trace=req.trace_id, run_id=session.run_id,
                )
            self.persist(session, out, telemetry=True)
            return out
        finally:
            ctx.close()

    # -- persistence ---------------------------------------------------------

    def persist(self, session: RunSession, out: output_mod.Result,
                telemetry: bool = False) -> None:
        """Flush one run's artifacts into its reserved dir (non-fatal).

        result.json / prompt.txt / consensus.md always; with
        ``telemetry`` and a live recorder, trace.json + metrics.json too —
        the serve-side spans (queue_wait/admit) and instants
        (cache_hit/coalesced) land in the same Chrome trace the CLI's
        ``--events`` produces. Only EXECUTED runs pass ``telemetry``:
        the recorder is process-scoped under serving (concurrent runs
        share it, so there is no per-request clear), meaning each
        snapshot covers everything since startup, bounded by
        ``LLMC_EVENTS_MAX`` — cheap once per real run, but pure overhead
        to rewrite for every cache hit and coalesced follower.
        """
        if not session.run_dir:
            return
        save_file(session.run_dir, "prompt.txt", out.prompt)
        save_file(session.run_dir, "consensus.md", out.consensus)
        save_file(session.run_dir, "result.json", self._stamp(out.to_json()))
        if not telemetry or self._obs is None:
            return
        from llm_consensus_tpu_torch.obs import export as obs_export

        trace_doc = obs_export.local_trace(self._obs)
        metrics_doc = obs_export.metrics_summary(
            self._obs,
            responses=out.responses,
            batcher_stats=obs_export.collect_batcher_stats(self._registry),
            kv_stats=obs_export.collect_kv_stats(self._registry),
            spec_stats=obs_export.collect_spec_stats(self._registry),
            disagg_stats=obs_export.collect_disagg_stats(self._registry),
            failed_models=out.failed_models,
            warnings=out.warnings,
            live=obs_export.live_summary(self._live),
            attrib=obs_export.attrib_summary(),
            roofline=obs_export.roofline_summary(),
        )
        obs_export.save_run_telemetry(session.run_dir, trace_doc, metrics_doc)

    def _stamp(self, payload: str) -> str:
        """With the integrity plane on, stamp ``result.json`` with a
        content digest over the fields the flywheel corpus distills from
        — ``build_corpus`` re-derives it before admitting the pair, so a
        run whose bytes rotted on disk is booked and excluded instead of
        training the student on garbage. Plane off: payload unchanged."""
        from llm_consensus_tpu_torch import integrity

        p = integrity.plane()
        if p is None:
            return payload
        try:
            doc = json.loads(payload)
        except ValueError:
            return payload
        if not isinstance(doc, dict):
            return payload
        doc["integrity_digest"] = integrity.pair_digest(doc)
        return json.dumps(doc, indent=2)

    def persist_copy(self, req: ServeRequest, out: output_mod.Result) -> RunSession:
        """A follower's / cache hit's own run dir for a shared result.

        Every served request keeps its own ``data/<run-id>/`` — distinct,
        collision-free run ids even when M requests shared one execution.
        """
        session = self.open_session(req)
        try:
            self.persist(session, out)
        finally:
            session.ctx.close()
        return session
