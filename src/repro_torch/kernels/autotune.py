"""Launch-plan selection for the CUDA kernels (``repro.kernels.autotune``).

Two layers, as in the reference:

1. **Heuristic table** (:func:`choose_blocks`): shape- and dtype-keyed rules
   that pick a kernel's launch plan without running anything. It is the one
   rule of each plan: the C launch entries take the plan as arguments and
   only check its hard limits.
2. **Measured autotune** (:func:`autotune`): time a candidate sweep for one
   op instance on the card and cache the winner, keyed by ``(op, dims,
   dtype, generation)``. :func:`choose_blocks` reads the cache before the
   heuristics, and the cache persists to JSON (:func:`save_cache` /
   :func:`load_cache`). Only an explicit sweep measures; training and
   serving never wait on one.

The plans with a free parameter on Hopper:

* the bf16 dense forward of every base format (``lora_fused``,
  ``lora_fused_q``, ``lora_fused_q4``): ``split``, the members of each
  output tile's cluster, which share K (``csrc/lora_dense_tc.cuh``);
* the bf16 dense dx (``lora_dx``, ``lora_dx_q``, ``lora_dx_q4``): ``split``
  over the contraction N (``csrc/lora_dense_dx_tc.cuh``);
* the bf16 grouped decode body over one shared base (``lora_grouped``,
  ``lora_grouped_q``, ``lora_grouped_q4`` with dims ``M, K, N, r, bm``):
  ``split`` over K and ``bn``, the column tile
  (``csrc/lora_grouped_decode_tc.cuh``); its ``part`` and ``h_cols``
  follow from the shapes (``lora_grouped.decode_plan``).

The others have a plan fixed at compile time or by the shapes, and their
dispatch still asks :func:`choose_blocks` (so the counters tick where the
reference's do), which returns that fixed plan (``FIXED_PLANS``) and
counts a miss without building a key: ``flash`` (64-row query and key
tiles, ``csrc/flash_common.cuh``), ``rmsnorm`` (one warp a row),
``lora_dab`` / ``lora_grouped_dab`` (``csrc/lora_dab_tc.cuh``'s
``plan_figures`` derive the cluster and passes from M, K, N and r) and the
grouped training bodies over expert stacks (``lora_grouped*`` with dims
``M, K, N, E, bm``: tiles of 256 columns, rows the layout's ``bm``).
:func:`autotune` refuses them: no kernel would read a plan swept for
them. Every f32 body (CUDA-core tiles) has no plan either: its heuristic
is ``{}``. Dispatch asks on the CUDA path only: a CPU tensor runs a plain
version, which has no plan.

Cache keys are ``op|k=v/...|dtype|<generation>``, the reference's format.
The generation is ``cpu`` without a card, else the card's name
(``torch.cuda.get_device_name()``) lower-cased with spaces turned to
``-``: plans transfer within a generation, not across. The key needs no
mesh tag, unlike the reference's: each rank of the port's data-parallel
runtime (``api/trainer.py``) launches its own kernels on its local batch,
so the dims it passes already describe the local problem, where the
reference traces global shapes under GSPMD (its ``_local_dims``).

Persisted caches are loaded lazily on first use (the generation needs the
card, and importing this module must not initialise CUDA), later winning:
``autotune_cache/<generation>.json`` beside this module, then the file
named by ``REPRO_TORCH_AUTOTUNE_CACHE``. No cache file is checked in.

No fallback: a plan read from the cache that the kernel refuses raises at
its launch; it never gives way to the heuristic.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, Iterable, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.telemetry.metrics import CounterGroup

# key -> {"split": ..., ...}
_CACHE: Dict[str, Dict[str, int]] = {}

#: module-global cache and sweep traffic counters ("autotune.*"):
#: module-level because kernel dispatch cannot depend on a run object; an
#: enabled Telemetry adopts this group into its registry
COUNTERS = CounterGroup(
    "autotune", ("cache_hit", "cache_miss", "sweeps", "sweep_candidates"))
#: the dispatch's two counters, ticked without the group's mapping calls
_HIT, _MISS = COUNTERS.counter("cache_hit"), COUNTERS.counter("cache_miss")

#: the last sweep's figures: op, dims, dtype, and each candidate's plan
#: with its ms a launch (None where the launch was refused)
LAST_SWEEP: dict = {}

#: checked-in per-generation caches would live here (none is committed)
CACHE_DIR = os.path.join(os.path.dirname(__file__), "autotune_cache")

#: the dense bodies' constants (``csrc/lora_dense_tc.cuh``, ``lora_tc.cuh``):
#: rows and columns of a block's tile, the contraction slab, the portable
#: cluster size, and the fewest slabs a member of the heuristic's split
DENSE_ROWS, DENSE_BN, DENSE_BK, DENSE_MAX_SPLIT, DENSE_MIN_SLABS = \
    64, 128, 32, 8, 4

DENSE_FWD_OPS = ("lora_fused", "lora_fused_q", "lora_fused_q4")
DENSE_DX_OPS = ("lora_dx", "lora_dx_q", "lora_dx_q4")
GROUPED_OPS = ("lora_grouped", "lora_grouped_q", "lora_grouped_q4",
               "lora_grouped_dx", "lora_grouped_dx_q", "lora_grouped_dx_q4")

#: the plans nothing can change (see the module docstring); the grouped
#: ops take theirs over expert stacks (dims with ``E``)
FIXED_PLANS: Dict[str, Dict[str, int]] = {
    "flash": {"bq": 64, "bk": 64}, "rmsnorm": {"rows_per_warp": 1},
    "lora_dab": {}, "lora_grouped_dab": {}}
GROUPED_TRAIN_PLAN: Dict[str, int] = {"bn": 256}


def cache_stats() -> Dict[str, int]:
    """Plain-dict view of the traffic counters (benchmarks, tests)."""
    return dict(COUNTERS)


@functools.lru_cache(maxsize=None)
def backend_generation() -> str:
    """The cache-file name and key suffix of this process's device: ``cpu``
    without a card, else the card's name lower-cased, spaces to ``-``."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().lower().replace(" ", "-")


def builtin_cache_path() -> str:
    return os.path.join(CACHE_DIR, backend_generation() + ".json")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _key(op: str, dims: Dict[str, int], dtype) -> str:
    d = "/".join(f"{k}={v}" for k, v in sorted(dims.items()))
    return f"{op}|{d}|{_dtype_name(dtype)}|{backend_generation()}"


@functools.lru_cache(maxsize=4096)
def _key_of(op: str, dims: tuple, dtype, generation: str) -> str:
    """:func:`_key` memoized on the dims as a dispatch passes them."""
    return _key(op, dict(dims), dtype)


@functools.lru_cache(maxsize=4096)
def _heuristic_of(op: str, dims: tuple, dtype, generation: str
                  ) -> Dict[str, int]:
    """:func:`_heuristic` on the current card, memoized as
    :func:`_key_of`: a generation (the card's name) fixes the SM count."""
    return _heuristic(op, dict(dims), dtype)


def _fixed(op: str, dims: Dict[str, int]) -> Optional[Dict[str, int]]:
    """The fixed plan of ``op`` at ``dims``, or None where it has a free
    parameter."""
    if op in GROUPED_OPS:
        return GROUPED_TRAIN_PLAN if "E" in dims else None
    return FIXED_PLANS.get(op)


_SMS: Dict[int, int] = {}


def _sms() -> int:
    """SMs of the current card (cached per device index)."""
    idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# ---------------------------------------------------------------------------
# heuristics
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dense_split(M: int, K: int, N: int, sms: int) -> int:
    """The dense bodies' rule for an M x K -> N product whose contraction K
    is split across a cluster: enough blocks for two on each of ``sms``
    SMs, at most ``DENSE_MAX_SPLIT`` members, each at least
    ``DENSE_MIN_SLABS`` slabs of ``DENSE_BK``. The dx calls it with N in
    K's place (its contraction is N)."""
    tiles = _cdiv(M, DENSE_ROWS) * _cdiv(N, DENSE_BN)
    slabs = _cdiv(K, DENSE_BK)
    return max(1, min(_cdiv(2 * sms, tiles), DENSE_MAX_SPLIT,
                      slabs // DENSE_MIN_SLABS))


def dense_split_limit(K: int) -> int:
    """The most members a dense split of contraction K may have (the C
    entries' hard limit: one a slab, at most the portable cluster)."""
    return min(DENSE_MAX_SPLIT, _cdiv(K, DENSE_BK))


@functools.lru_cache(maxsize=4096)
def _heuristic_cached(op: str, dims: tuple, dtype: str, sms: int):
    d = dict(dims)
    fixed = _fixed(op, d)
    if fixed is not None:
        return fixed
    bf16 = dtype == "bfloat16"
    if op in DENSE_FWD_OPS:
        return {"split": dense_split(d["M"], d["K"], d["N"], sms)} \
            if bf16 else {}
    if op in DENSE_DX_OPS:
        return {"split": dense_split(d["M"], d["N"], d["K"], sms)} \
            if bf16 else {}
    if op in GROUPED_OPS:
        if not bf16:
            return {}
        from repro_torch.kernels.lora_grouped import decode_plan
        plan = decode_plan(d["M"], d["K"], d["N"], d["r"], bm=d["bm"],
                           sms=sms)
        return {"split": plan["split"], "bn": plan["bn"]}
    raise ValueError(f"unknown op {op!r}")


#: the ops whose heuristic reads the card's SM count (in bf16)
_SM_OPS = frozenset(DENSE_FWD_OPS + DENSE_DX_OPS + GROUPED_OPS)


def _heuristic(op: str, dims: Dict[str, int], dtype,
               sms: Optional[int] = None) -> Dict[str, int]:
    """The heuristic plan of ``op`` at ``dims`` (see the module docstring);
    ``sms`` defaults to the current card's SM count where a rule needs it."""
    name = _dtype_name(dtype)
    if sms is None:
        sms = _sms() if op in _SM_OPS and name == "bfloat16" else 0
    return dict(_heuristic_cached(op, tuple(sorted(dims.items())), name,
                                  sms))


def choose_blocks(op: str, dtype=torch.float32, **dims: int
                  ) -> Dict[str, int]:
    """Measured-cache lookup, else the heuristic table. An op with a
    fixed plan counts a miss and returns it without a key."""
    fixed = _fixed(op, dims)
    if fixed is not None:
        _MISS.value += 1
        return dict(fixed)
    _ensure_loaded()
    items, gen = tuple(dims.items()), backend_generation()
    hit = _CACHE.get(_key_of(op, items, dtype, gen))
    if hit is not None:
        _HIT.value += 1
        return dict(hit)
    _MISS.value += 1
    return dict(_heuristic_of(op, items, dtype, gen))


# ---------------------------------------------------------------------------
# measured autotune
# ---------------------------------------------------------------------------

#: launches a round, and rounds a candidate (its time: the fastest round's
#: mean)
LAUNCHES_PER_ROUND = 20


def _graph_ms(fn: Callable[[], object], repeats: int) -> float:
    """ms a launch of ``fn`` on the card: ``LAUNCHES_PER_ROUND`` launches
    captured in a CUDA graph (on a side stream), replayed ``repeats``
    times between CUDA events; the fastest replay's mean. The graph keeps
    the host's dispatch out of the reading, which at small shapes would
    otherwise outweigh the kernel."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()                                    # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(LAUNCHES_PER_ROUND):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        g.replay()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / LAUNCHES_PER_ROUND)
    del g
    return best


def autotune(op: str, run: Callable[[Dict[str, int]], object], *,
             candidates: Iterable[Dict[str, int]], dtype=torch.float32,
             repeats: int = 5, want: Optional[torch.Tensor] = None,
             tol: Optional[dict] = None, **dims: int) -> Dict[str, int]:
    """Time ``run(plan)`` for each candidate plan on the card, cache and
    return the fastest.

    ``run`` launches the kernel with the plan and returns its output. Each
    candidate is timed by CUDA events around replays of a CUDA graph of
    its launches (device time: the host's dispatch left out,
    :func:`_graph_ms`). Each candidate's first launch is a warm-up, never
    timed; a candidate whose launch is refused there
    (``_build.LaunchRefused``: a plan past an entry's hard limits, a
    cluster the card cannot hold) is skipped, and counted in
    ``sweep_candidates`` as the reference counts it. Any other failure
    raises. With ``want`` (the plain version's output on the same inputs)
    that first output must match it at ``tol``
    (``torch.testing.assert_close`` keywords): a plan that computes
    another answer raises ValueError with the plan in the message and is
    never crowned. A sweep in which no candidate launches raises
    RuntimeError, and so does a sweep of an op with a fixed plan."""
    if _fixed(op, dims) is not None:
        raise RuntimeError(f"{op} at {dims} has a fixed plan: nothing to "
                           "sweep")
    _ensure_loaded()
    COUNTERS["sweeps"] += 1
    best, best_ms, times = None, float("inf"), []
    for plan in candidates:
        plan = dict(plan)
        COUNTERS["sweep_candidates"] += 1
        try:
            out = run(plan)                     # warm-up: never timed
            if isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize()
        except _build.LaunchRefused:
            times.append((plan, None))
            continue
        if want is not None:
            try:
                torch.testing.assert_close(out.float(), want.float(),
                                           **(tol or {}))
            except AssertionError as e:
                raise ValueError(f"{op} plan {plan} at {dims} computes "
                                 f"another answer than the plain version: "
                                 f"{e}") from None
        ms = _graph_ms(lambda: run(plan), repeats)
        times.append((plan, ms))
        if ms < best_ms:
            best, best_ms = plan, ms
    LAST_SWEEP.clear()
    LAST_SWEEP.update(op=op, dims=dict(dims), dtype=_dtype_name(dtype),
                      times=times)
    if best is None:
        raise RuntimeError(f"{op} at {dims}: no candidate plan launched")
    _CACHE[_key(op, dims, dtype)] = dict(best)
    return dict(best)


def load_cache(path: str) -> int:
    """Merge a JSON cache file; returns the number of entries loaded."""
    with open(path) as f:
        data = json.load(f)
    _CACHE.update({k: {kk: int(vv) for kk, vv in v.items()}
                   for k, v in data.items()})
    return len(data)


def save_cache(path: Optional[str] = None) -> str:
    """Persist the measured cache; the default target is this generation's
    file under ``CACHE_DIR``. Only the current generation's entries are
    written (keys end in ``|<generation>``): the merged in-memory cache may
    hold entries loaded from another generation's file."""
    path = path or builtin_cache_path()
    suffix = f"|{backend_generation()}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: v for k, v in _CACHE.items() if k.endswith(suffix)},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def clear_cache() -> None:
    """Forget every measured plan (a fresh cache: the next lookups miss
    until :func:`load_cache` or a sweep fills it)."""
    _CACHE.clear()


_LOADED = False


def _ensure_loaded() -> None:
    """First-use loads: this generation's file under ``CACHE_DIR``, then
    the ``REPRO_TORCH_AUTOTUNE_CACHE`` override (its entries win)."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    for path in (builtin_cache_path(),
                 os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")):
        if path and os.path.exists(path):
            load_cache(path)
