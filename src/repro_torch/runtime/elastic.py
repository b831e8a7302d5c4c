"""Elastic mesh planning (port of ``repro/runtime/elastic.py``): rebuild the
(pod, data, model) mesh from whatever ranks survive, keeping TP intact and
shrinking DP.

The 'model' axis is baked into layer shapes' divisibility, so elasticity
keeps it and re-plans (pod, data) from the surviving count; the checkpoint
re-places saved (unsharded) leaves under the new mesh
(``checkpoint.restore(shardings=...)``). The planning is the pure
``plan_mesh_shape``; ``plan_mesh`` builds the ``DeviceMesh``.
"""

from __future__ import annotations

import math
from typing import Tuple


def plan_mesh_shape(n_devices: int, model: int = 16, prefer_pods: int = 2) -> Tuple[int, int, int]:
    """Largest (pod, data, model) fitting n_devices with fixed TP."""
    if n_devices < model:
        # degenerate small-host case: shrink TP to fit
        model = math.gcd(n_devices, model) or 1
    chips_per_pod_max = n_devices // prefer_pods
    pods = prefer_pods
    if chips_per_pod_max < model:
        pods = 1
    data = (n_devices // pods) // model
    if data < 1:
        pods, data = 1, max(1, n_devices // model)
    return pods, data, model


def plan_mesh(n_devices: int, *, model: int = 16, prefer_pods: int = 2,
              device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``plan_mesh_shape`` over the first
    pods * data * model ranks of the world."""
    from repro_torch.launch.mesh import make_mesh

    shape = plan_mesh_shape(n_devices, model=model, prefer_pods=prefer_pods)
    return make_mesh(shape, ("pod", "data", "model"), device_type=device_type)
