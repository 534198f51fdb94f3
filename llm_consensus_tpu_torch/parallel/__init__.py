"""Device placement of the port (a part of ``llm_consensus_tpu/parallel/``).

Only the role split of disaggregated serving is here (:mod:`.mesh`
``split_roles``); the rest of the JAX package's placement (meshes,
sharding, ring and pipeline parallelism, multi-controller runs) is not
ported yet.
"""

from llm_consensus_tpu_torch.parallel.mesh import best_tp, split_roles  # noqa: F401

__all__ = ["best_tp", "split_roles"]
