"""Mesh construction over the ranks of a process group
(``repro.launch.mesh``).

:func:`make_production_mesh` is the reference's production mesh: 16 x 16
ranks a pod, ``("data", "model")``, or 2 x 16 x 16 over two pods,
``("pod", "data", "model")``, over the first ranks of the world.
:func:`make_host_mesh` lays out whatever ranks exist (1 without a process
group) as a ``(data, model)`` mesh. Both are functions, so importing this
module touches no process group.
"""
from __future__ import annotations

from repro_torch.runtime.elastic import (DeviceMesh, make_mesh_from_devices,
                                         world_size)

#: ranks on each axis of a pod: (data, model)
POD = (16, 16)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 ranks a pod; 2 pods (512 ranks) with ``multi_pod``. Raises
    ValueError when the world has fewer ranks."""
    pods = 2 if multi_pod else 1
    need = pods * POD[0] * POD[1]
    n = world_size()
    if n < need:
        raise ValueError(f"the production mesh needs {need} ranks "
                         f"({'2 x ' if multi_pod else ''}16 x 16); the "
                         f"world has {n}")
    return make_mesh_from_devices(list(range(need)), POD[1], pods=pods)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """Small mesh over whatever ranks exist (tests, CPU examples): the
    model axis is ``min(model_parallel, ranks)``, the data axis the rest."""
    n = world_size()
    mp = min(model_parallel, n)
    return make_mesh_from_devices(list(range(n // mp * mp)), mp)
