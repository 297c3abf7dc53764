"""The training runtime around the step (``repro.runtime``): fault
injection, the step guard, the degradation ladder, the supervised
resilient loop, and elastic data and tensor parallelism over
``torch.distributed`` (``runtime/elastic.py``: the mesh's data axis and
its model axis, whose Megatron collectives ``models/parallel.py`` wraps;
the model axis runs the dense family, ``ROADMAP.md`` §1, item 3)."""
from repro_torch.runtime import (degrade, elastic,  # noqa: F401
                                 fault_tolerance, faults, guard)
