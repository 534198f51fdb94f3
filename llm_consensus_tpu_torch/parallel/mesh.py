"""Topology: device handles, meshes, and the carving of a run's devices
into per-model slices (port of ``llm_consensus_tpu/parallel/mesh.py``).

A JAX device is a chip the runtime enumerates; a port's :class:`Device`
is a *mesh position*: an ``id``, the ``process_index`` of the controller
that drives it, and the ``torch.device`` its work is issued on. Several
positions may share one torch device (:func:`virtual_devices`, the port's
counterpart of ``--xla_force_host_platform_device_count``): tests put 8 on
the CPU, and one card can run a whole sharded path over 2-8 positions.

A :class:`Mesh` is a numpy array of handles with ``axis_names``, the
shape of ``jax.sharding.Mesh``. Axis conventions (parallel/, train/):

  dp — data (batch) parallelism
  pp — pipeline stages (parallel/pipeline.py)
  sp — sequence parallelism: ring attention (parallel/ring.py) for engine
       prefill
  tp — tensor parallelism (parallel/sharding.py); doubles as the expert
       axis for MoE unless a dedicated ``ep`` axis is present

The planning (``plan_panel``, ``split_roles``, the host-aware
``_plan_multihost``) is the JAX package's, rule for rule, so the same
device count and hosts give the same placements by device id.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Device:
    """One mesh position: its global ``id``, the controller process that
    drives it, and the ``torch.device`` its shard lives and runs on."""

    id: int
    process_index: int
    torch_device: torch.device

    def __repr__(self) -> str:
        return f"Device(id={self.id}, process={self.process_index}, {self.torch_device})"


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_devices(device: DeviceLike = None) -> list[Device]:
    """One handle per visible card of this process (ids offset by the
    process index times the card count, so they are global), or one
    handle for ``device`` when it is given (``"cpu"`` for the CPU).
    ``None`` with no card raises, as every entry point does."""
    pi = _process_index()
    if device is not None:
        return [Device(pi, pi, resolve_device(device))]
    resolve_device(None)  # raises without a card
    n = torch.cuda.device_count()
    return [Device(pi * n + i, pi, torch.device("cuda", i)) for i in range(n)]


def virtual_devices(n: int, device: DeviceLike = None) -> list[Device]:
    """``n`` handles with distinct ids (offset by ``process_index * n``),
    all backed by the one torch ``device``."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    dev = resolve_device(device)
    pi = _process_index()
    return [Device(pi * n + i, pi, dev) for i in range(n)]


def pvary(x, axis_name):
    """No counterpart in the port. JAX marks a ``shard_map`` carry as
    device-varying for its type system; the port's shards are separate
    tensors issued position by position, so nothing needs marking. Kept
    as the identity for callers that name it."""
    return x


class Mesh:
    """Devices arranged on named axes: ``devices`` is a numpy object array
    of :class:`Device` handles whose dims follow ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, flat_index: int) -> dict:
        """Axis name → index of the ``flat_index``-th position (the order of
        ``devices.flat``)."""
        idx = np.unravel_index(flat_index, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def flat_index(self, **coords) -> int:
        """The flat position of ``coords`` (axes left out count as 0)."""
        idx = tuple(int(coords.get(a, 0)) for a in self.axis_names)
        return int(np.ravel_multi_index(idx, self.devices.shape))

    def __repr__(self) -> str:
        ids = np.vectorize(lambda d: d.id)(self.devices) if self.size else []
        return f"Mesh({self.shape}, ids={np.asarray(ids).tolist()})"


def make_mesh(axis_sizes: dict, devices: Sequence[Device]) -> Mesh:
    """A mesh with the given ``{axis_name: size}`` (insertion order) over
    ``devices``. Sizes must multiply to ``len(devices)``; ``-1`` for at
    most one axis infers its size (like numpy reshape)."""
    devices = list(devices)
    n = len(devices)
    sizes = dict(axis_sizes)
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one axis may be -1, got {unknown}")
    known = 1
    for s in sizes.values():
        if s != -1:
            known *= s
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = 1
    for s in sizes.values():
        total *= s
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes.values())), tuple(sizes))


def carve_slices(devices: Sequence[Device], sizes: Sequence[int]) -> list[list[Device]]:
    """Consecutive disjoint slices of ``devices`` of ``sizes``."""
    if sum(sizes) > len(devices):
        raise ValueError(f"requested {sum(sizes)} devices across slices, have {len(devices)}")
    out, i = [], 0
    for s in sizes:
        if s <= 0:
            raise ValueError(f"slice size must be positive, got {s}")
        out.append(list(devices[i:i + s]))
        i += s
    return out


def best_tp(cfg, n_devices: int) -> int:
    """Largest valid tensor-parallel degree <= ``n_devices`` for ``cfg``:
    a power of two dividing ``n_kv_heads``, ``n_heads``, ``d_ff`` and
    ``n_devices`` (1 always works)."""
    tp = 1
    d = 1
    while d <= n_devices:
        if (cfg.n_kv_heads % d == 0 and cfg.n_heads % d == 0 and cfg.d_ff % d == 0
                and n_devices % d == 0):
            tp = d
        d *= 2
    return tp


@dataclass
class ModelPlacement:
    """One model pinned to a device slice with a concrete mesh.
    ``prefill_mesh`` is set only under disaggregated serving
    (:func:`split_roles`): ``mesh`` is then the decode role's."""

    model: str
    cfg: object
    mesh: Mesh
    role: str  # "panel" | "judge"
    prefill_mesh: Optional[Mesh] = None

    @property
    def n_devices(self) -> int:
        return self.mesh.size


@dataclass
class MeshPlan:
    """Placement of a whole consensus run onto the available devices."""

    placements: list = field(default_factory=list)

    def for_model(self, model: str) -> Optional[ModelPlacement]:
        for p in self.placements:
            if p.model == model:
                return p
        return None


def host_groups(devices: Sequence[Device]) -> list[list[Device]]:
    """Devices grouped by ``process_index``, processes in index order."""
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    return [by_proc[p] for p in sorted(by_proc)]


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def split_roles(cfg, devices: Sequence, prefill_fraction: float = 0.5
                ) -> tuple[Optional[list], list]:
    """``(prefill devices, decode devices)`` of one preset's ``devices``.

    With two or more devices the carving is the JAX package's: both roles
    get power-of-two slices, disjoint; the decode role keeps the LEADING
    devices with its own :func:`best_tp`, and the prefill role, taken from
    the end of the slice, matches the decode degree whenever its share
    affords it (matched degrees keep the handed-off bytes equal to what the
    decode engine would compute itself), else its own best degree.
    ``prefill_fraction`` is clamped to [0.05, 0.9]. Each list is as long as
    its role's tensor-parallel degree (:func:`split_role_meshes` makes the
    meshes).

    **Departure: one device serves both roles.** The JAX split returns no
    prefill role for a slice of fewer than two devices, so disaggregation
    does nothing there. On one card the port gives both roles that device:
    the prefill worker runs on a CUDA stream of its own beside the decode
    loop (engine/handoff.py). With none this raises ``ValueError``."""
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("split_roles needs at least one device")
    if n < 2:
        return [devices[0]], [devices[0]]
    f = min(max(float(prefill_fraction), 0.05), 0.9)
    p = _pow2_floor(max(1, int(n * f)))
    if p >= n:
        p = _pow2_floor(n - 1)
    d = _pow2_floor(n - p)
    tp_d = best_tp(cfg, d)
    tp_p = tp_d if tp_d <= p else best_tp(cfg, p)
    return devices[n - p:n - p + tp_p], devices[:tp_d]


def split_role_meshes(cfg, devices: Sequence[Device], prefill_fraction: float = 0.5
                      ) -> tuple[Optional[Mesh], Mesh]:
    """:func:`split_roles` as ``{"dp": 1, "tp": n}`` meshes, the JAX
    ``split_roles``' return: a slice of one device gives ``(None, its
    mesh)``, no prefill role (the provider then gives both roles the
    decode device, the port's one-device departure)."""
    devices = list(devices)
    if len(devices) < 2:
        tp = best_tp(cfg, len(devices))
        return None, make_mesh({"dp": 1, "tp": tp}, devices[:tp])
    pdevs, ddevs = split_roles(cfg, devices, prefill_fraction)
    return (make_mesh({"dp": 1, "tp": len(pdevs)}, pdevs),
            make_mesh({"dp": 1, "tp": len(ddevs)}, ddevs))


def plan_panel(panel: Sequence[tuple], judge: Optional[tuple] = None,
               devices: Optional[Sequence[Device]] = None, judge_fraction: float = 0.5,
               hosts: Optional[Sequence[Sequence[Device]]] = None,
               disagg_fraction: Optional[float] = None,
               multihost_placement: bool = True) -> MeshPlan:
    """Place panel models + judge on disjoint slices of ``devices``.

    Policy (the JAX package's): the judge gets ``judge_fraction`` of the
    devices rounded down to a power of two, taken from the END of the
    list; the rest split evenly across panel models, power-of-two slices,
    shared round-robin (with a warning) when models outnumber devices.
    **Host-aware placement** (whenever ``devices`` spans several
    processes, or an explicit ``hosts`` grouping): every model's slice
    stays within one host, weight-proportionally (:func:`_plan_multihost`).
    ``multihost_placement=False`` (``LLMC_MULTIHOST_PLACEMENT=0``, resolved
    by utils/knobs.py) forces single-domain planning. ``devices`` is
    required: the provider passes its own (``local_devices()`` or the
    handles it was given)."""
    if not panel and judge is None:
        return MeshPlan()
    if hosts is not None:
        groups = [list(g) for g in hosts]
        devices = [d for g in groups for d in g]
    elif devices is None:
        raise ValueError("plan_panel needs devices (or hosts)")
    else:
        devices = list(devices)
        groups = host_groups(devices) if multihost_placement else [devices]
    if len(groups) > 1:
        return _plan_multihost(panel, judge, groups, judge_fraction,
                               disagg_fraction=disagg_fraction)

    def placed(name: str, cfg, slice_devs, role: str) -> ModelPlacement:
        if disagg_fraction is not None and len(slice_devs) >= 2:
            pmesh, dmesh = split_role_meshes(cfg, slice_devs, disagg_fraction)
            return ModelPlacement(name, cfg, dmesh, role, prefill_mesh=pmesh)
        tp = best_tp(cfg, len(slice_devs))
        return ModelPlacement(name, cfg, make_mesh({"dp": 1, "tp": tp}, slice_devs[:tp]), role)

    n = len(devices)
    plan = MeshPlan()
    remaining = devices
    if judge is not None and n >= 2:
        j = _pow2_floor(max(1, int(n * judge_fraction)))
        judge_devs, remaining = remaining[n - j:], remaining[:n - j]
    elif judge is not None:
        judge_devs = devices  # one device: the judge shares it
    else:
        judge_devs = []

    if panel:
        per = max(1, _pow2_floor(len(remaining) // len(panel))) if remaining else 1
        pool = remaining if remaining else devices
        taken: set = set()
        for i, (name, cfg) in enumerate(panel):
            start = (i * per) % max(1, len(pool))
            devs = pool[start:start + per]
            if len(devs) < per:  # wrap: share the pool round-robin
                devs = (pool + pool)[start:start + per]
            p = placed(name, cfg, devs, "panel")
            used = [d for m in (p.prefill_mesh, p.mesh) if m is not None for d in m.devices.flat]
            if taken & {d.id for d in used}:
                _warn_wrap_sharing(name, used)
            taken |= {d.id for d in used}
            plan.placements.append(p)

    if judge is not None:
        name, cfg = judge
        plan.placements.append(placed(name, cfg, judge_devs, "judge"))
    return plan


def _warn_wrap_sharing(name: str, devs: Sequence[Device]) -> None:
    """Models outnumber devices: slices time-multiplex; say so."""
    warnings.warn(
        f"model {name!r} shares chips {sorted(d.id for d in devs)} with another placement "
        "(more models than devices): decode loops will time-multiplex the slice",
        RuntimeWarning, stacklevel=3,
    )


def _plan_multihost(panel: Sequence[tuple], judge: Optional[tuple], groups: list,
                    judge_fraction: float = 0.5,
                    disagg_fraction: Optional[float] = None) -> MeshPlan:
    """Host-aware placement, weight-proportional (the JAX rule): the
    heaviest model first onto the host where it keeps weight per device
    lowest, then each host's models take power-of-two shares of its
    devices in proportion to their parameter counts; ``judge_fraction``
    scales the judge's weight (0.5 = its real size)."""
    plan = MeshPlan()
    hosts = sorted(groups, key=len, reverse=True)
    jf = min(max(judge_fraction, 0.01), 0.99)
    items = [(name, cfg, "panel", float(max(1, cfg.n_params(active_only=True))))
             for name, cfg in panel]
    if judge is not None:
        name, cfg = judge
        items.append((name, cfg, "judge",
                      float(max(1, cfg.n_params(active_only=True))) * (jf / (1.0 - jf))))
    items.sort(key=lambda it: -it[3])
    loads = [0.0] * len(hosts)
    assigned: list[list] = [[] for _ in hosts]
    for it in items:
        h = min(range(len(hosts)), key=lambda i: ((loads[i] + it[3]) / len(hosts[i]), i))
        assigned[h].append(it)
        loads[h] += it[3]

    for host, its in zip(hosts, assigned):
        if not its:
            continue
        total = sum(w for *_, w in its)
        start = 0
        for name, cfg, role, w in its:
            per = min(len(host), max(1, _pow2_floor(int(len(host) * w / total))))
            devs = host[start:start + per]
            if len(devs) < per:  # wrap: share the host round-robin
                devs = (host + host)[start % len(host):][:per]
                _warn_wrap_sharing(name, devs)
            start += per
            if disagg_fraction is not None and len(devs) >= 2:
                pmesh, dmesh = split_role_meshes(cfg, devs, disagg_fraction)
                plan.placements.append(ModelPlacement(name, cfg, dmesh, role, prefill_mesh=pmesh))
            else:
                tp = best_tp(cfg, len(devs))
                plan.placements.append(
                    ModelPlacement(name, cfg, make_mesh({"dp": 1, "tp": tp}, devs[:tp]), role))
    return plan


__all__ = ["Device", "Mesh", "MeshPlan", "ModelPlacement", "best_tp", "carve_slices",
           "host_groups", "local_devices", "make_mesh", "plan_panel", "pvary",
           "split_role_meshes", "split_roles", "virtual_devices"]
