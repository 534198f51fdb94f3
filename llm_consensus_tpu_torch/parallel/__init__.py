"""The port's parallelism layer (``llm_consensus_tpu/parallel/``): meshes of
torch devices, sharding specs and shards, ring and pipeline parallelism,
and multi-controller runs over ``torch.distributed``.

One process per host drives that host's devices (a JAX controller's
GSPMD over its chips, made explicit: each shard's work is issued on its own
device and the partial sums reduced in process); ``torch.distributed``
joins processes only across hosts, where they exchange results.

Modules:
  mesh            device handles, meshes, per-model slice carving
  sharding        spec trees for params and caches, shards, collectives
  ring            ring attention (sequence parallelism)
  pipeline        GPipe pipeline parallelism
  distributed     process-group init, hybrid DCN x ICI meshes
  multicontroller per-process ownership, the host-side result exchange
"""

from llm_consensus_tpu_torch.parallel.distributed import hybrid_mesh, initialize
from llm_consensus_tpu_torch.parallel.mesh import (
    Device, Mesh, MeshPlan, ModelPlacement, best_tp, carve_slices, local_devices, make_mesh,
    plan_panel, split_roles, virtual_devices)
from llm_consensus_tpu_torch.parallel.pipeline import pipeline_forward
from llm_consensus_tpu_torch.parallel.ring import ring_attention
from llm_consensus_tpu_torch.parallel.sharding import (
    cache_specs, make_shard_fn, param_specs, shard_pytree)

__all__ = [
    "Device", "Mesh", "MeshPlan", "ModelPlacement", "best_tp", "cache_specs", "carve_slices",
    "hybrid_mesh", "initialize", "local_devices", "make_mesh", "make_shard_fn", "param_specs",
    "pipeline_forward", "plan_panel", "ring_attention", "shard_pytree", "split_roles",
    "virtual_devices",
]
