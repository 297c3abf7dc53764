"""Step times of two ``chip_smoke.py`` outputs side by side.

Reads the JSON lines two runs of ``chip_smoke.py`` printed (say a parent
commit's and a change's, run in one call on one card) and prints, for
every phase that reports one, the steady ms a step of each run and their
ratio: serving (``ms_per_step``), training (``ms_per_step``, the median
after the first step where the phase gives it) and the Trainer's median
step.

    python scripts/compare_smoke_steps.py parent.out change.out
"""
from __future__ import annotations

import json
import sys


def step_times(path: str) -> dict:
    """{phase/path: ms} of every ``ms_per_step`` and ``median_step_ms`` in
    the JSON lines of ``path``."""
    out = {}

    def walk(node, where):
        if not isinstance(node, dict):
            return
        for key, value in node.items():
            here = f"{where}/{key}" if where else key
            if key in ("ms_per_step", "median_step_ms") and \
                    isinstance(value, (int, float)):
                out[where] = float(value)
            else:
                walk(value, here)

    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    walk(json.loads(line), "")
                except json.JSONDecodeError:
                    continue
    return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (step_times(p) for p in argv)
    print(f"{'phase':48s} {'first ms':>10s} {'second ms':>10s} {'ratio':>7s}")
    for name in sorted(set(a) | set(b)):
        x, y = a.get(name), b.get(name)
        ratio = f"{y / x:7.3f}" if x and y else "      -"
        fmt = lambda v: f"{v:10.1f}" if v is not None else f"{'-':>10s}"
        print(f"{name:48s} {fmt(x)} {fmt(y)} {ratio}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
