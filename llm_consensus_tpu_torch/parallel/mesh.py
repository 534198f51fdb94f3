"""Role split of one preset's devices for disaggregated serving (the
``split_roles`` of ``llm_consensus_tpu/parallel/mesh.py`` and its
power-of-two helpers, over a list of ``torch.device``).

The JAX package returns meshes; the port returns the device lists, each
as long as its role's tensor-parallel degree (the JAX mesh's ``tp`` axis),
since the port runs a model on one device and has no mesh yet.

**Departure: one device serves both roles.** The JAX split returns no
prefill role for a slice of fewer than two devices, so disaggregation
does nothing there. On one card the port gives both roles that device:
the prefill worker runs its waves on a CUDA stream of its own beside the
decode loop (engine/handoff.py), and the handoff is a same-device copy
into the decode engine's KV pool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


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


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def split_roles(cfg, devices: Sequence[torch.device], prefill_fraction: float = 0.5
                ) -> tuple[Optional[list], list]:
    """``(prefill devices, decode devices)`` of one preset's ``devices``.

    With two or more devices the carving is the JAX package's: both roles
    get power-of-two slices, disjoint; the decode role keeps the LEADING
    devices with its own :func:`best_tp`, and the prefill role, taken from
    the end of the slice, matches the decode degree whenever its share
    affords it (matched degrees keep the handed-off bytes equal to what the
    decode engine would compute itself), else its own best degree.
    ``prefill_fraction`` is clamped to [0.05, 0.9].

    With one device both roles get it (the port's departure, see the
    module docstring); with none this raises ``ValueError``."""
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


__all__ = ["best_tp", "split_roles"]
