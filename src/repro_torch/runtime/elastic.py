"""Elastic data parallelism on ``torch.distributed`` (``repro.runtime.
elastic``): the mesh of ranks, placement onto it, the global batch across a
resize, and the data axis's gradient sync.

The reference reshards a jitted program onto a ``jax.sharding.Mesh``. The
port runs one process a rank (``gloo`` for CPU tensors, ``nccl`` for the
card), each holding the whole model and its own rows of the global batch:

* :func:`make_mesh_from_devices` lays the surviving ranks out as a
  :class:`DeviceMesh` with the reference's axes (``("data", "model")``, or
  ``("pod", "data", "model")`` over several pods) and its errors;
* :func:`reshard_tree` is data-parallel placement: every leaf replicated on
  the mesh's ranks by a broadcast from its first rank. Values are not
  touched, so a round trip is bit-exact;
* :func:`rebalance_batch` keeps the global batch over a new rank count;
* :class:`DataParallel` is the data axis of a mesh: between
  ``value_and_grad`` and the optimizer each engine's step all-reduces the
  LoRA gradients and the loss over it (``api/engines.py``), so that every
  rank applies the update of the whole global batch.

The loss is a mean over the valid tokens (label -1 ignored). Rank r holds
n_r of the N valid tokens of the global batch, so the sync weights rank
r's mean loss and gradients by n_r / N before summing: the sum is then the
single-process batch's mean and gradient, for any split of the labels
(InternVL2-1B's -1 prefix labels included). On one rank n_r / N is exactly
1.0 and nothing is all-reduced, so a mesh of one rank gives the bits of no
mesh. The gradients travel as f32 whatever the model's dtype: one f32
buffer of every LoRA leaf and the loss a step (the count of valid tokens
goes first, alone). The bytes handed to ``all_reduce`` are counted in
:attr:`DataParallel.bytes_all_reduced`.

Only the data axis is ported: a mesh with a model axis above 1 can be laid
out (its geometry is the reference's) but no Trainer takes it
(``TrainSpec.validate``; ``ROADMAP.md`` §1, item 3, the model axis).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Ranks laid out over named axes: ``ranks`` is an int array of shape
    ``[sizes of axis_names]``."""
    ranks: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def rank_list(self) -> List[int]:
        return [int(r) for r in self.ranks.reshape(-1)]

    @property
    def data_size(self) -> int:
        """Ranks along the data-parallel axes (pod x data)."""
        s = self.shape
        return s.get("pod", 1) * s.get("data", 1)


def make_mesh_from_devices(devices: Sequence[int], model_parallel: int,
                           pods: int = 1) -> DeviceMesh:
    """The largest (pod, data, model) mesh over a surviving rank set.

    Axis naming matches the reference's: ``("data", "model")`` for a single
    pod, ``("pod", "data", "model")`` when ``pods > 1``. Raises
    ``ValueError`` when the survivor count is not divisible by
    ``model_parallel × pods``: the caller drops stragglers to a divisible
    count first."""
    n = len(devices)
    if model_parallel < 1 or pods < 1:
        raise ValueError(f"model_parallel={model_parallel} and pods={pods} "
                         "must be >= 1")
    if n == 0 or n % (model_parallel * pods) != 0:
        raise ValueError(
            f"{n} surviving devices not divisible by "
            f"model={model_parallel} x pods={pods}; shrink to a divisible "
            f"survivor count before resizing")
    data = n // (model_parallel * pods)
    arr = np.asarray([int(d) for d in devices[:pods * data * model_parallel]],
                     dtype=np.int64).reshape(pods, data, model_parallel)
    if pods == 1:
        return DeviceMesh(arr[0], ("data", "model"))
    return DeviceMesh(arr, ("pod", "data", "model"))


#: process groups by their ranks: ``dist.new_group`` is collective over the
#: whole world, so every rank asks for the same meshes in the same order
_GROUPS: Dict[Tuple[int, ...], object] = {}


def group_of(mesh: DeviceMesh):
    """The process group over ``mesh``'s ranks, or None when there is no
    process group (a mesh of one rank in a process of its own). The world
    group when the mesh is the whole world in order; else made once by
    ``dist.new_group``, which every rank of the world must call alike."""
    if not dist.is_initialized():
        if mesh.size > 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs a process "
                               "group; torch.distributed is not initialized")
        return None
    ranks = tuple(mesh.rank_list)
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def reshard_tree(tree, mesh: DeviceMesh, group=None):
    """Data-parallel placement: every tensor leaf of ``tree`` replicated on
    ``mesh``'s ranks by a broadcast from its first rank (in place on the
    other members; None and non-tensor leaves pass through). On a mesh of
    one rank nothing moves. Call it on every member of the mesh."""
    if mesh.size == 1:
        return tree
    group = group if group is not None else group_of(mesh)
    src = mesh.rank_list[0]

    def put(leaf):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, src=src, group=group)
        return leaf

    return tree_map(put, tree)


def rebalance_batch(global_batch: int, old_hosts: int, new_hosts: int) -> int:
    """Per-host batch after a resize, keeping the global batch invariant."""
    if new_hosts < 1 or global_batch % new_hosts != 0:
        raise ValueError(
            f"global batch {global_batch} cannot be kept invariant over "
            f"{new_hosts} hosts — choose a divisor count")
    return global_batch // new_hosts


class DataParallel:
    """The data axis of ``mesh`` for this rank: the gradient and loss sync
    of every engine's step (see the module docstring)."""

    def __init__(self, mesh: DeviceMesh, group=None):
        if mesh.shape.get("model", 1) != 1:
            raise ValueError("only the data axis is ported: the mesh has a "
                             f"model axis of {mesh.shape['model']} "
                             "(ROADMAP.md §1, item 3)")
        self.mesh = mesh
        self.group = group
        self.size = mesh.data_size
        me = rank()
        if me not in mesh.rank_list:
            raise ValueError(f"rank {me} is not on the mesh "
                             f"{mesh.rank_list}")
        self.index = mesh.rank_list.index(me)
        #: bytes handed to ``all_reduce`` since the last reset
        self.bytes_all_reduced = 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows: its
        ``rebalance_batch`` share, or all of them where ``n`` does not
        divide over the ranks (a halved batch below the data size): then
        every rank takes the whole batch and the sync averages identical
        copies."""
        if n % self.size:
            return slice(0, n)
        per = rebalance_batch(n, self.size, self.size)
        return slice(self.index * per, (self.index + 1) * per)

    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            self.bytes_all_reduced += buf.numel() * buf.element_size()
            dist.all_reduce(buf, group=self.group)
        return buf

    def weight(self, labels: torch.Tensor) -> float:
        """n_r / N: this rank's share of the global batch's valid tokens
        (label >= 0); one f32 all-reduce of the count."""
        n = (labels >= 0).sum().to(torch.float32).reshape(1)
        total = float(self._all_reduce(n.clone())[0])
        return float(n[0]) / max(total, 1.0)

    def all_reduce(self, tensors: Sequence[torch.Tensor], w: float
                   ) -> List[torch.Tensor]:
        """Σ over the ranks of ``w · t`` for each tensor, in one f32
        buffer; each result in its tensor's dtype and shape."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors]) * w
        flat = self._all_reduce(flat)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def reduce(self, loss, grads, labels):
        """(loss, grads) of the global batch from this rank's: each weighted
        by n_r / N and summed over the ranks. ``grads`` keeps its nesting
        (None at frozen leaves)."""
        w = self.weight(labels)
        leaves = tree_leaves(grads)
        out = self.all_reduce([loss.reshape(1)] + leaves, w)
        return out[0].reshape(loss.shape), unflatten(grads, out[1:])
