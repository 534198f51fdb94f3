"""Multi-controller runner: each process queries the models it owns and
the results merge through one bounded allgather (port of
``llm_consensus_tpu/runner/multihost.py``).

The best-effort fan-out of runner.py across controller processes:
host-aware placement gives every model one owner process, this runner has
that process alone query it, and the exchange leaves every process with
the identical merged :class:`RunResult`, so the all-fail check, the judge
prompt, rounds and votes behave as if one process had queried everything.
A controller that misses the exchange's deadline costs its models, not
the run: they are booked into ``failed_models`` with a warning, and only
a total wipeout raises.
"""

from __future__ import annotations

import warnings
from collections import deque
from dataclasses import asdict
from typing import Callable, Optional

from llm_consensus_tpu_torch.providers.base import Response
from llm_consensus_tpu_torch.runner.runner import AllModelsFailed, Runner, RunResult
from llm_consensus_tpu_torch.utils.context import Context


class MultiControllerRunner(Runner):
    """Runner whose fan-out spans controller processes. ``owner_fn(model)``
    gives the process that queries ``model``
    (parallel/multicontroller.py ``model_owner``); progress callbacks fire
    for locally owned models only. ``allgather_timeout`` overrides the
    exchange deadline (None: the run context's remaining time, capped by
    ``allgather_cap``, the ``LLMC_ALLGATHER_TIMEOUT`` knob)."""

    def __init__(self, *args, owner_fn: Callable[[str], int],
                 allgather_timeout: Optional[float] = None,
                 allgather_cap: Optional[float] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._owner_fn = owner_fn
        self._allgather_timeout = allgather_timeout
        self._allgather_cap = allgather_cap

    def run(self, ctx: Context, models: list[str], prompt: str) -> RunResult:
        from llm_consensus_tpu_torch.parallel import multicontroller as mc

        me = mc.process_index()
        owned = [m for m in models if self._owner_fn(m) == me]
        local = self._collect(ctx, owned, prompt)
        payload = {"responses": [asdict(r) for r in local.responses],
                   "warnings": local.warnings, "failed_models": local.failed_models}
        if self._allgather_timeout is not None:
            deadline = self._allgather_timeout
        elif self._allgather_cap is not None:
            deadline = mc.allgather_timeout(ctx, self._allgather_cap)
        else:
            deadline = mc.allgather_timeout(ctx)
        gathered, missing = mc.allgather_json_bounded(payload, deadline)

        # Responses ordered by the caller's model list (every controller must
        # agree on it); a name asked N times answers N times.
        merged = RunResult()
        pool: dict[str, deque] = {}
        for part in gathered:
            if part is None:
                continue  # a controller that missed the deadline
            for d in part["responses"]:
                pool.setdefault(d["model"], deque()).append(Response(**d))
            merged.warnings.extend(part["warnings"])
            merged.failed_models.extend(part["failed_models"])
        if missing:
            lost = set(missing)
            for m in dict.fromkeys(models):
                owner = self._owner_fn(m)
                if owner in lost and not pool.get(m):
                    merged.failed_models.append(m)
                    merged.warnings.append(
                        f"{m}: controller {owner} missed the allgather deadline "
                        f"({deadline:.1f}s); merging survivors")
            warnings.warn(f"controllers {sorted(lost)} missed the allgather deadline "
                          f"({deadline:.1f}s); continuing with survivors",
                          RuntimeWarning, stacklevel=2)
        for m in models:
            q = pool.get(m)
            if q:
                merged.responses.append(q.popleft())
        for q in pool.values():  # responses for names the list did not hold
            merged.responses.extend(q)
        if not merged.responses:
            raise AllModelsFailed("all models failed: " + "; ".join(merged.warnings))
        return merged


__all__ = ["MultiControllerRunner"]
