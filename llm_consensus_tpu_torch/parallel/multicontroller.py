"""Multi-controller execution: per-process engine ownership and the
host-side exchange of results (port of
``llm_consensus_tpu/parallel/multicontroller.py``).

Every process runs the same program; host-aware planning
(parallel/mesh.py) keeps each model's slice inside one process, so each
model has exactly one owner that builds and drives its engine while the
others receive its results:

  * **Panel fan-out**: each process queries the models it owns
    (runner/multihost.py), then one allgather leaves every process with the
    identical merged result, so the judge prompt, rounds and votes agree.
  * **Judge synthesis**: the judge's owner runs the query and broadcasts
    the text (or the error) to the rest (:class:`BroadcastProvider`).

The bytes travel as CPU ``uint8`` tensors over the gloo group
parallel/distributed.py makes (a length exchange, then the padded
payloads), never through NCCL, so two processes may share one card. With
one process every primitive is the identity.

Degraded mode (the JAX rule): the bounded allgather waits at most a
deadline, merges what arrived and remembers the peers that missed it;
from then on the run makes no collective at all. ``controller_drop`` and
``controller_late`` faults at the ``allgather`` site simulate such peers
in one process.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict
from typing import Optional

import torch

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.providers.base import Provider, Request, Response, StreamCallback
from llm_consensus_tpu_torch.utils.context import Context

DEFAULT_ALLGATHER_TIMEOUT_S = 60.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _group():
    from llm_consensus_tpu_torch.parallel.distributed import gloo_group

    return gloo_group()


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def is_multicontroller() -> bool:
    """True when several controller processes share this run."""
    return process_count() > 1


def mesh_owner(mesh) -> int:
    """The process that drives engines on ``mesh``: the least
    ``process_index`` over its devices (the same on every process)."""
    return min(d.process_index for d in mesh.devices.flat)


def model_owner(registry, model: str) -> int:
    """Owner process of ``model``: its placement's process for on-device
    models, process 0 for everything else (remote providers run anywhere;
    one process must own them so they are queried once)."""
    try:
        provider = registry.get(model)
    except Exception:  # noqa: BLE001 — an unknown model: process 0 reports it
        return 0
    placement = getattr(provider, "placement", None)
    if placement is None:
        return 0
    try:
        mesh = placement(model)
    except Exception:  # noqa: BLE001
        return 0
    return 0 if mesh is None else mesh_owner(mesh)


# -- byte-level collectives ---------------------------------------------------


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Every process's ``payload``, in process order (a length allgather,
    then a padded payload allgather); the identity in one process."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [payload]
    group, n = _group(), dist.get_world_size()
    length = torch.tensor([len(payload)], dtype=torch.int64)
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    width = max(1, max(int(x) for x in lengths))
    buf = torch.zeros(width, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    parts = [torch.zeros(width, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return [bytes(p[:int(k)].numpy().tobytes()) for p, k in zip(parts, lengths)]


def broadcast_bytes(payload: Optional[bytes], owner: int) -> bytes:
    """``payload`` from process ``owner`` to everyone (None elsewhere)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        assert payload is not None
        return payload
    group = _group()  # over every rank: its ranks are the global ones
    me = dist.get_rank()
    length = torch.tensor([len(payload) if me == owner else 0], dtype=torch.int64)
    dist.broadcast(length, src=owner, group=group)
    n = int(length)
    buf = torch.zeros(max(n, 1), dtype=torch.uint8)
    if me == owner and n:
        buf[:n] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    dist.broadcast(buf, src=owner, group=group)
    return bytes(buf[:n].numpy().tobytes())


def allgather_json(obj) -> list:
    return [json.loads(p.decode("utf-8")) for p in allgather_bytes(json.dumps(obj).encode("utf-8"))]


def broadcast_json(obj, owner: int):
    payload = json.dumps(obj).encode("utf-8") if process_index() == owner else None
    return json.loads(broadcast_bytes(payload, owner).decode("utf-8"))


def global_devices(local: list) -> list:
    """Every process's device handles, in process order, from this
    process's ``local`` ones (one allgather of their ids and torch devices;
    the identity in one process). A remote handle's ``torch_device`` names
    that process's device and is never used here."""
    from llm_consensus_tpu_torch.parallel.mesh import Device

    if not is_multicontroller():
        return list(local)
    me = process_index()
    mine = {d.id: d for d in local}
    parts = allgather_json([[d.id, d.process_index, str(d.torch_device)] for d in local])
    return [mine[i] if pi == me else Device(i, pi, torch.device(dev))
            for part in parts for i, pi, dev in part]


# -- degraded mode ------------------------------------------------------------

_degraded_lock = sanitizer.make_lock("parallel.degraded")
_degraded: set[int] = set()


def mark_degraded(peers) -> None:
    """Record controller processes that missed a collective deadline (an
    instant on the run's timeline when the recorder is on)."""
    peers = [int(p) for p in peers]
    with _degraded_lock:
        new = [p for p in peers if p not in _degraded]
        _degraded.update(peers)
    if new:
        from llm_consensus_tpu_torch import obs

        r = obs.recorder()
        if r is not None:
            r.instant("degraded", tid="mc", peers=sorted(new))


def degraded_peers() -> frozenset:
    """Controllers known to have dropped out of this run's collectives."""
    with _degraded_lock:
        return frozenset(_degraded)


def reset_degraded() -> None:
    """Forget dropped peers (tests, or a fresh run on a healed cluster)."""
    with _degraded_lock:
        _degraded.clear()


def allgather_timeout(ctx: Optional[Context] = None, cap: float = DEFAULT_ALLGATHER_TIMEOUT_S
                      ) -> float:
    """Deadline for one bounded allgather: the run context's remaining
    budget when it has one, capped by ``cap`` (``LLMC_ALLGATHER_TIMEOUT``,
    resolved by utils/knobs.py; 60 s): a run with no deadline must still
    never hang on a dead peer."""
    rem = ctx.remaining() if ctx is not None else None
    return cap if rem is None else min(cap, rem)


def _simulated_allgather(fs, payload: bytes, timeout: Optional[float]):
    """A ``controller_drop`` / ``controller_late`` fault on one gather: the
    peer topology it names (``host=H`` implies H + 1 controllers); a late
    peer within the deadline is a normal gather, one past it is dropped."""
    me = process_index()
    host = int(fs.param("host", 1))
    if fs.kind == "controller_late":
        delay = float(fs.param("s", 0.05))
        if timeout is None or delay <= timeout:
            time.sleep(delay)
            return allgather_bytes(payload), []
        time.sleep(timeout)
    n = max(process_count(), host + 1, me + 1)
    # As on the real timeout path: once a gather times out every other
    # peer's payload and liveness is unknown, so all of them are missing.
    missing = [i for i in range(n) if i != me]
    mark_degraded(missing)
    return [payload if i == me else None for i in range(n)], missing


def allgather_bytes_bounded(payload: bytes, timeout: Optional[float] = None
                            ) -> "tuple[list[Optional[bytes]], list[int]]":
    """Every reachable process's payload, and who missed the deadline:
    ``(parts, missing)``, ``parts[i]`` None for an absent process. The
    exchange is a span ``allgather`` on the recorder and device-unavailable
    time in the attribution ledger (family ``allgather``)."""
    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.obs.attrib import tag as attrib_tag

    r = obs.recorder()
    led = obs.attrib.ledger()
    if r is None and led is None:
        return _allgather_bytes_bounded(payload, timeout)
    t0 = r.now() if r is not None else 0
    t0_wall = time.monotonic()
    with attrib_tag("allgather"):
        parts, missing = _allgather_bytes_bounded(payload, timeout)
    if r is not None:
        r.complete("allgather", t0, tid="mc", bytes=len(payload), peers=len(parts),
                   missing=list(missing), timeout_s=timeout)
    if led is not None:
        led.observe_device("allgather", time.monotonic() - t0_wall)
    return parts, missing


def _allgather_bytes_bounded(payload: bytes, timeout: Optional[float] = None):
    from llm_consensus_tpu_torch import faults

    plan = faults.plan()
    if plan is not None:
        fs = plan.fire("allgather")
        if fs is not None:
            return _simulated_allgather(fs, payload, timeout)
    if not is_multicontroller():
        return [payload], []
    if degraded_peers():
        # Lockstep was lost earlier this run: another collective would only
        # pay the deadline again, or hang a peer that did arrive.
        me, n = process_index(), process_count()
        return [payload if i == me else None for i in range(n)], [i for i in range(n) if i != me]
    box: dict = {}

    def work() -> None:
        try:
            box["parts"] = allgather_bytes(payload)
        except BaseException as err:  # noqa: BLE001 — re-raised below
            box["err"] = err

    t = threading.Thread(target=work, daemon=True, name="llmc-allgather")
    t.start()
    t.join(timeout)
    if t.is_alive():
        me, n = process_index(), process_count()
        missing = [i for i in range(n) if i != me]
        mark_degraded(missing)
        return [payload if i == me else None for i in range(n)], missing
    if "err" in box:
        raise box["err"]
    return box["parts"], []


def allgather_json_bounded(obj, timeout: Optional[float] = None) -> "tuple[list, list[int]]":
    parts, missing = allgather_bytes_bounded(json.dumps(obj).encode("utf-8"), timeout)
    return [None if p is None else json.loads(p.decode("utf-8")) for p in parts], missing


# -- judge broadcast provider -------------------------------------------------


class BroadcastProvider(Provider):
    """Runs queries on the owner process and broadcasts the results.

    Every process reaches the same judge call sites with the same merged
    inputs; the owner does the work, and the response (or the error, which
    re-raises identically everywhere) broadcasts. Streaming callbacks fire
    with real chunks on the owner and once with the whole text elsewhere.
    Once any peer is degraded no broadcast is attempted: every survivor
    serves the query from its local provider (only process 0 emits output,
    so the copies are never both shown)."""

    name = "broadcast"

    def __init__(self, inner: Provider, owner: int):
        self._inner = inner
        self._owner = owner
        self.name = getattr(inner, "name", "broadcast")

    def query(self, ctx: Context, req: Request) -> Response:
        return self.query_stream(ctx, req, None)

    def query_stream(self, ctx: Context, req: Request,
                     callback: Optional[StreamCallback]) -> Response:
        me = process_index()
        if degraded_peers():
            return self._inner.query_stream(ctx, req, callback)
        payload: Optional[dict] = None
        if me == self._owner:
            try:
                payload = {"ok": asdict(self._inner.query_stream(ctx, req, callback))}
            except Exception as err:  # noqa: BLE001 — re-raised after the broadcast
                payload = {"err": f"{type(err).__name__}: {err}"}
        payload = broadcast_json(payload, self._owner)
        if "err" in payload:
            raise RuntimeError(payload["err"])
        resp = Response(**payload["ok"])
        if me != self._owner and callback is not None:
            callback(resp.content)
        return resp


__all__ = ["BroadcastProvider", "DEFAULT_ALLGATHER_TIMEOUT_S", "allgather_bytes",
           "allgather_bytes_bounded", "allgather_json", "allgather_json_bounded",
           "allgather_timeout", "broadcast_bytes", "broadcast_json", "degraded_peers",
           "global_devices", "is_multicontroller", "mark_degraded", "mesh_owner",
           "model_owner", "process_count", "process_index", "reset_degraded"]
