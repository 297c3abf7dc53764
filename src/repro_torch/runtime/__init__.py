"""The training runtime around the step (``repro.runtime``): fault
injection, the step guard, the degradation ladder and the supervised
resilient loop. The reference's ``runtime/elastic.py`` (a mesh helper) is
not ported: the port runs on one device (``ROADMAP.md`` item 8)."""
from repro_torch.runtime import (degrade, fault_tolerance, faults,  # noqa: F401
                                 guard)
