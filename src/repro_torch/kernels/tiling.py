"""Host-side tile schedules for the grouped kernels (the grouped part of
``repro.kernels.tiling``).

A ragged group layout is a tuple of row counts, one per group, zero-size
groups allowed. :func:`grouped_schedule` lays the groups out in tiles of
``bm`` rows, each group's rows padded to whole tiles and an empty group
given none, and :func:`pack_ragged_rows` / :func:`unpack_ragged_rows`
move rows between the concatenated layout and the packed one. The
schedule is plain Python, cached per (sizes, bm) as the reference's is;
the row index is made each call; the packing is PyTorch indexing, so
gradients flow through it.

The reference's flash-attention schedules (``flash_schedule`` and its
statistics) are not ported: the port's flash kernels walk their own tiles
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def ceil_to(n: int, mult: int) -> int:
    """Smallest multiple of ``mult`` that is >= n."""
    return -(-n // mult) * mult


def pad_dim(x, mult: int, axis: int):
    """Zero-pad ``axis`` of x up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis % x.ndim)
    widths[-1] = pad
    return torch.nn.functional.pad(x, widths)


@functools.lru_cache(maxsize=None)
def grouped_schedule(group_sizes: tuple, bm: int):
    """Tile schedule for a ragged group layout padded to ``bm`` rows.

    Group g with ``s = group_sizes[g] > 0`` rows occupies a contiguous
    ``ceil_to(s, bm)``-row span of the packed layout; an empty group
    occupies nothing (no tile is launched for it). Returns ``(gid,
    offs)``: int32 numpy ``gid[t]``, the group of tile t, and int64
    ``offs[g]``, the packed row offset of group g (``offs[-1]`` the packed
    rows). A group's tiles are contiguous, as the dA/dB kernel requires."""
    gid, offs = [], [0]
    for g, s in enumerate(group_sizes):
        t = ceil_to(int(s), bm) // bm
        gid.extend([g] * t)
        offs.append(offs[-1] + t * bm)
    return np.asarray(gid, np.int32), np.asarray(offs, np.int64)


def _rows_index(group_sizes: tuple, bm: int, device):
    """int64 index of each concatenated row in the packed layout."""
    _, offs = grouped_schedule(group_sizes, bm)
    idx = np.concatenate([np.arange(s, dtype=np.int64) + offs[g]
                          for g, s in enumerate(group_sizes)]
                         or [np.zeros(0, np.int64)])
    return torch.from_numpy(idx).to(device)


def pack_ragged_rows(x, group_sizes: tuple, bm: int):
    """[M, K] concatenated ragged groups -> [Mp, K] with every group's span
    zero-padded to a ``bm`` multiple (so each tile sees one group only)."""
    sizes = tuple(int(s) for s in group_sizes)
    Mp = int(grouped_schedule(sizes, bm)[1][-1])
    out = x.new_zeros((Mp,) + tuple(x.shape[1:]))
    return out.index_copy(0, _rows_index(sizes, bm, x.device), x)


def unpack_ragged_rows(xp, group_sizes: tuple, bm: int):
    """Inverse of :func:`pack_ragged_rows`: each group's valid rows out of
    the padded layout, concatenated."""
    sizes = tuple(int(s) for s in group_sizes)
    return xp.index_select(0, _rows_index(sizes, bm, xp.device))


def grouped_schedule_stats(group_sizes: tuple, bm: int) -> dict:
    """Live-tile counts of a ragged group layout, against the batched
    ``[E, Cmax, ·]`` layout (every group padded to the largest) that a
    plain batched product would launch."""
    sizes = [int(s) for s in group_sizes]
    gid, offs = grouped_schedule(tuple(sizes), bm)
    cmax = max(sizes) if sizes else 0
    dense = len(sizes) * (ceil_to(cmax, bm) // bm)
    live = int(len(gid))
    return {
        "bm": bm,
        "groups": len(sizes),
        "empty_groups": sum(1 for s in sizes if s == 0),
        "rows": sum(sizes),
        "padded_rows": int(offs[-1]),
        "dense_tiles": dense,
        "live_tiles": live,
        "grid_fraction": live / float(dense) if dense else 1.0,
    }
