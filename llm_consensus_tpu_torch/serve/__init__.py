"""Persistent consensus serving (port of ``llm_consensus_tpu/serve/``):
gateway, admission, coalescing, cache, and the fleet tier over them.

The one-shot CLI pays a full process lifecycle per prompt and its engines
die with the run; this package keeps them resident. ``build_gateway``
wires the single-replica layers — admission (bounded priority queue +
backpressure + drain), single-flight coalescing + result cache, per-request
run sessions and the pressure governor — over a shared provider registry.
The CLI's ``serve`` subcommand (cli/serve.py) and the tests build through
it. ``build_router`` wires the fleet tier over N gateways — the health
monitor, consistent-hash placement with failover, the spillover lane and
the elastic controller (live stream migration rides the gateways'
``/v1/retire`` and ``/v1/migrate``); ``route`` (cli/route.py) builds
through it.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.pressure import PRIORITY_LOW, PressureGovernor
from llm_consensus_tpu_torch.providers import Registry
from llm_consensus_tpu_torch.runner.runner import DEFAULT_STALL_GRACE_S
from llm_consensus_tpu_torch.serve.admission import (
    AdmissionController,
    ClientGone,
    Draining,
    QueueFull,
    RetryLater,
)
from llm_consensus_tpu_torch.serve.cache import (
    ConsensusCache,
    Flight,
    FlightFailed,
    FlightTable,
    cache_key,
)
from llm_consensus_tpu_torch.serve.elastic import ElasticController
from llm_consensus_tpu_torch.serve.fleet import FleetState, HealthMonitor
from llm_consensus_tpu_torch.serve.gateway import ConsensusGateway
from llm_consensus_tpu_torch.serve.router import ConsensusRouter, SpilloverPolicy
from llm_consensus_tpu_torch.serve.scheduler import RunSession, Scheduler, ServeRequest
from llm_consensus_tpu_torch.serve.stats import StatsRegistry

__all__ = [
    "AdmissionController",
    "ClientGone",
    "ConsensusCache",
    "ConsensusGateway",
    "ConsensusRouter",
    "Draining",
    "ElasticController",
    "FleetState",
    "Flight",
    "FlightFailed",
    "FlightTable",
    "HealthMonitor",
    "PressureGovernor",
    "QueueFull",
    "RetryLater",
    "RunSession",
    "Scheduler",
    "ServeRequest",
    "SpilloverPolicy",
    "StatsRegistry",
    "build_gateway",
    "build_router",
    "cache_key",
]

# The governor's settings keys (utils/knobs.py ``pressure_settings``).
_GOVERNOR_KEYS = ("poll_s", "high_water", "low_water", "up_patience", "down_patience",
                  "evict_target", "judge_fallback", "brownout_max_new", "shed_class")


def build_gateway(
    registry: Registry,
    models: list[str],
    judge: str,
    *,
    system: Optional[str] = None,
    max_tokens: Optional[int] = None,
    timeout: float = 120.0,
    max_concurrency: int = 4,
    max_queue: int = 16,
    cache_size: int = 256,
    cache_ttl_s: float = 300.0,
    data_dir: str = "data",
    save: bool = True,
    host: str = "127.0.0.1",
    port: int = 0,
    log=None,
    clock=None,
    governor=None,
    live=None,
    lifecycle: Optional[str] = None,
    pressure: Optional[dict] = None,
    judge_overlap: bool = False,
    stall_grace: float = DEFAULT_STALL_GRACE_S,
    **gateway_settings,
) -> ConsensusGateway:
    """Assemble a gateway over an initialized registry (not yet started).

    A :class:`~llm_consensus_tpu_torch.pressure.PressureGovernor` is built
    and wired by default (``pressure={"enabled": False}`` disables; pass
    ``governor`` explicitly to override): it samples this gateway's
    admission queue, batcher headroom, and KV-pool pressure, and walks the
    evict → preempt → brownout → shed ladder under overload. Its thread
    starts with the gateway and stops on close.

    ``pressure`` holds the governor's and the admission controller's
    settings (``utils/knobs.py`` ``pressure_settings``; missing keys take
    the JAX defaults). ``stall_grace`` is the runners' watchdog grace
    (``LLMC_STALL_GRACE``). ``gateway_settings`` go to
    :class:`ConsensusGateway` (``warm_s``, ``quarantine_after``,
    ``probe_n``, ``slo_ttft_p99_s``, ``slo_windows``, ``features``).
    ``live`` overrides the process-wide live metrics plane (obs/live) —
    multi-replica-in-one-process tests pass one instance per gateway so
    each replica's ``/metricsz`` stays its own."""
    pressure = dict(pressure or {})
    scheduler = Scheduler(registry, data_dir=data_dir, save=save, live=live,
                          judge_overlap=judge_overlap, stall_grace=stall_grace)
    admission_kwargs = {k: pressure[k] for k in ("age_s", "retry_spread") if k in pressure}
    admission = AdmissionController(
        max_concurrency=max_concurrency, max_queue=max_queue, **admission_kwargs
    )
    cache_kwargs = {} if clock is None else {"clock": clock}
    cache = ConsensusCache(
        capacity=cache_size, ttl_s=cache_ttl_s, **cache_kwargs
    )
    if governor is None and pressure.get("enabled", True):
        def _providers() -> list:
            seen: set = set()
            out = []
            for model in registry.models():
                provider = registry.get(model)
                if id(provider) in seen:
                    continue
                seen.add(id(provider))
                out.append(provider)
            return out

        governor = PressureGovernor(
            admission_snapshot=admission.snapshot,
            provider_iter=_providers,
            **{k: pressure[k] for k in _GOVERNOR_KEYS if k in pressure},
        )
        # priority_storm's synthetic admits enter through the REAL
        # controller — the flood competes for the same queue and slots
        # production traffic uses.
        governor._storm_admit = lambda: admission.admit(
            priority=PRIORITY_LOW
        )
    return ConsensusGateway(
        scheduler,
        admission,
        cache,
        registry=registry,
        models=models,
        judge=judge,
        system=system,
        max_tokens=max_tokens,
        timeout=timeout,
        host=host,
        port=port,
        log=log,
        governor=governor,
        live=live,
        lifecycle=lifecycle,
        **gateway_settings,
    )


def build_router(
    replicas: list[str],
    *,
    poll_s: float = 2.0,
    suspect_after: int = 1,
    dead_after: int = 3,
    revive_after: int = 2,
    saturation: float = 0.85,
    canary_fraction: float = 0.0,
    spillover_registry=None,
    spillover_models: Optional[list[str]] = None,
    spillover_judge: Optional[str] = None,
    spillover_policy: Optional[SpilloverPolicy] = None,
    data_dir: str = "data",
    save: bool = False,
    host: str = "127.0.0.1",
    port: int = 0,
    log=None,
    probe=None,
    min_replicas: int = 1,
    max_replicas: int = 8,
    scale_up=None,
    scale_down=None,
    elastic: Optional[ElasticController] = None,
    elastic_settings: Optional[dict] = None,
) -> ConsensusRouter:
    """Assemble a fleet router (not yet started) over ``replicas`` —
    static gateway URLs; more join live via heartbeat registration.
    ``probe`` overrides the health monitor's HTTP prober (tests).

    An :class:`ElasticController` is always wired (pass ``elastic`` to
    override): ``POST /v1/scale`` works out of the box.
    ``elastic_settings`` holds the controller's hysteresis and cadence
    (``utils/knobs.py`` ``elastic_settings``; missing keys take the JAX
    defaults) and ``enabled``, which starts its tick thread with the
    router; its clamps are ``min_replicas`` and ``max_replicas``.
    ``scale_up``/``scale_down`` are the membership hooks — launching or
    retiring an actual replica is deployment-specific, so the default hooks
    are inert (decisions are booked and counted; nothing launches). The
    other arguments carry the fleet knobs (``utils/knobs.py``
    ``fleet_settings``) with the JAX defaults."""
    settings = dict(elastic_settings or {})
    fleet = FleetState(
        suspect_after=suspect_after,
        dead_after=dead_after,
        revive_after=revive_after,
    )
    for url in replicas:
        fleet.add_static(url)
    monitor = HealthMonitor(fleet, poll_s=poll_s, probe=probe)
    if elastic is None:
        elastic = ElasticController(
            fleet=fleet,
            scale_up=scale_up,
            scale_down=scale_down,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            **{k: settings[k] for k in _ELASTIC_KEYS if k in settings},
        )
    return ConsensusRouter(
        fleet,
        monitor,
        spillover_registry=spillover_registry,
        spillover_models=spillover_models,
        spillover_judge=spillover_judge,
        spillover_policy=spillover_policy,
        saturation=saturation,
        canary_fraction=canary_fraction,
        elastic=elastic,
        start_elastic=bool(settings.get("enabled", False)),
        data_dir=data_dir,
        save=save,
        host=host,
        port=port,
        log=log,
    )


# The elastic controller's settings keys (utils/knobs.py ``elastic_settings``).
_ELASTIC_KEYS = ("high_water", "low_water", "up_patience", "down_patience", "tick_s")
