"""Multi-host distribution: joining a ``torch.distributed`` process group,
and hybrid meshes whose outer axes cross processes (port of
``llm_consensus_tpu/parallel/distributed.py``).

  * :func:`initialize` joins the group ``init_process_group`` makes, with
    the ``cpu:gloo,cuda:nccl`` backend (gloo for CPU tensors, NCCL for
    CUDA ones) and a TCP rendezvous at the coordinator. With no
    configuration and no launcher markers it is a no-op, so the CLI calls
    it unconditionally. It also makes the gloo group the result exchange
    rides (parallel/multicontroller.py): CPU ``uint8`` tensors over gloo
    never open an NCCL communicator, which two ranks on one card could not.
  * :func:`hybrid_mesh`: DCN axes (outer) over processes, ICI axes (inner)
    over each process's local devices, so tensor collectives stay inside a
    host and only the outer axes (the dp gradient all-reduce) cross hosts.

The port's modules read no ``LLMC_*`` variable: utils/knobs.py
``distributed_settings`` resolves ``LLMC_COORDINATOR``,
``LLMC_NUM_PROCESSES``, ``LLMC_PROCESS_ID`` and ``LLMC_DISTRIBUTED`` and the
CLI passes them. The launcher markers :func:`_pod_env` reads are the
launcher's own variables, as the JAX package reads ``MEGASCALE_*`` and
``TPU_WORKER_*``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Mapping, Optional, Sequence

import numpy as np

from llm_consensus_tpu_torch.parallel.mesh import Device, Mesh, host_groups

_GLOO_GROUP = None


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _pod_env(force: bool = False, environ: Optional[Mapping[str, str]] = None) -> bool:
    """True in a multi-process launch whose environment names every
    argument (``init_method="env://"``): ``force`` (``LLMC_DISTRIBUTED=1``),
    torchrun's elastic agent (``TORCHELASTIC_RUN_ID``), or a launcher's
    ``WORLD_SIZE`` above 1. ``WORLD_SIZE=1`` (a single-process launch) is
    not one, as one ``TPU_WORKER_HOSTNAMES`` host is not a pod in JAX."""
    env = os.environ if environ is None else environ
    if force:
        return True
    if env.get("TORCHELASTIC_RUN_ID"):
        return True
    try:
        return int(env.get("WORLD_SIZE", "") or 0) > 1
    except ValueError:
        return False


def _backend() -> str:
    import torch

    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, force: bool = False,
               timeout_s: float = 600.0) -> bool:
    """Join (or skip joining) the process group; True if joined.

    Explicit arguments (the CLI passes ``LLMC_COORDINATOR`` /
    ``LLMC_NUM_PROCESSES`` / ``LLMC_PROCESS_ID``, resolved by
    utils/knobs.py) rendezvous at ``tcp://<coordinator_address>``; with
    none, a launcher's environment (:func:`_pod_env`, or ``force``) joins
    through ``env://``; with neither this is a no-op and single-process
    runs never block on a coordinator."""
    import torch.distributed as dist

    global _GLOO_GROUP
    if is_initialized():
        return True
    if not coordinator_address and not num_processes:
        if not _pod_env(force):
            return False
        dist.init_process_group(backend=_backend(), init_method="env://",
                                timeout=timedelta(seconds=timeout_s))
    else:
        if not coordinator_address or not num_processes or process_id is None:
            raise ValueError("a coordinator address, a process count and a process id "
                             "are needed together")
        dist.init_process_group(backend=_backend(),
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timedelta(seconds=timeout_s))
    _GLOO_GROUP = dist.new_group(backend="gloo")
    return True


def gloo_group():
    """The gloo group the byte exchange rides (None before :func:`initialize`
    or in a process that joined a group some other way: then the default
    group, whose CPU half is gloo)."""
    return _GLOO_GROUP


def shutdown() -> None:
    """Leave the process group (a no-op when not joined)."""
    import torch.distributed as dist

    global _GLOO_GROUP
    if is_initialized():
        dist.destroy_process_group()
    _GLOO_GROUP = None


def hybrid_mesh(dcn_axes: dict, ici_axes: dict, devices: Sequence[Device]) -> Mesh:
    """A mesh with ``dcn_axes`` crossing processes and ``ici_axes`` within
    them. The DCN axes (outer) partition ``devices`` into per-process
    granules when they span several processes, else into contiguous equal
    splits (single-process virtual meshes); the ICI axes order each granule."""
    devices = list(devices)
    n_granules = int(np.prod(list(dcn_axes.values()) or [1]))
    per_granule = int(np.prod(list(ici_axes.values()) or [1]))
    if n_granules * per_granule != len(devices):
        raise ValueError(f"mesh {dcn_axes}×{ici_axes} needs {n_granules * per_granule} "
                         f"devices, have {len(devices)}")
    grouped = host_groups(devices)
    if len(grouped) > 1:
        granules = grouped
        if len(granules) != n_granules or any(len(g) != per_granule for g in granules):
            raise ValueError(f"DCN axes {dcn_axes} want {n_granules} granules of "
                             f"{per_granule}; processes provide {[len(g) for g in granules]}")
    else:
        granules = [devices[i * per_granule:(i + 1) * per_granule] for i in range(n_granules)]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [d for g in granules for d in g]
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    return Mesh(arr.reshape(shape), tuple(dcn_axes) + tuple(ici_axes))


__all__ = ["gloo_group", "hybrid_mesh", "initialize", "is_initialized", "shutdown"]
