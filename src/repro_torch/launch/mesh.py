"""Mesh construction over the ranks of a process group
(``repro.launch.mesh``).

:func:`make_host_mesh` lays out the world's ranks (1 without a process
group) as a ``(data, model)`` mesh. The reference's production mesh (16 x
16 chips a pod, ``make_production_mesh``) needs the model axis, which is
not ported yet (``ROADMAP.md`` §1, item 3).
"""
from __future__ import annotations

from repro_torch.runtime.elastic import (DeviceMesh, make_mesh_from_devices,
                                         world_size)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """Small mesh over whatever ranks exist (tests, CPU examples): the
    model axis is ``min(model_parallel, ranks)``, the data axis the rest."""
    n = world_size()
    mp = min(model_parallel, n)
    return make_mesh_from_devices(list(range(n // mp * mp)), mp)
