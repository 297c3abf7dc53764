"""Elastic data and tensor parallelism on ``torch.distributed``
(``repro.runtime.elastic``): the mesh of ranks, placement onto it, the
global batch across a resize, the data axis's gradient sync and the model
axis's collectives.

The reference reshards a jitted program onto a ``jax.sharding.Mesh``. The
port runs one process a rank (``gloo`` for CPU tensors, ``nccl`` for the
card), each holding its shard of the model and its rows of the global
batch:

* :func:`make_mesh_from_devices` lays the surviving ranks out as a
  :class:`DeviceMesh` with the reference's axes (``("data", "model")``, or
  ``("pod", "data", "model")`` over several pods) and its errors; its
  process groups are those of the whole mesh, of this rank's data axis
  (the ranks that share its model index) and of its model axis (the ranks
  that share its data index), :func:`mesh_groups`;
* :func:`reshard_tree` places a whole tree on the mesh: every leaf
  broadcast from the mesh's first rank, then sliced along the dim its
  spec (``launch/sharding.py``) puts on ``model``; :func:`gather_tree`
  gathers the slices back. Values are not touched, so a round trip is
  bit-exact;
* :func:`rebalance_batch` keeps the global batch over a new rank count;
* :class:`DataParallel` is the data axis of a mesh: between
  ``value_and_grad`` and the optimizer each engine's step all-reduces the
  LoRA gradients and the loss over it (``api/engines.py``), so that every
  rank applies the update of the whole global batch;
* :class:`ModelParallel` is the model axis: this rank's index on it and
  its collectives, which ``models/parallel.py`` wraps as autograd
  Functions (Megatron tensor and sequence parallelism).

The loss is a mean over the valid tokens (label -1 ignored). Rank r holds
n_r of the N valid tokens of the global batch, so the sync weights rank
r's mean loss and gradients by n_r / N before summing: the sum is then the
single-process batch's mean and gradient, for any split of the labels
(InternVL2-1B's -1 prefix labels included). On one rank n_r / N is exactly
1.0 and nothing is all-reduced, so a mesh of one rank gives the bits of no
mesh. The gradients travel as f32 whatever the model's dtype: one f32
buffer of every LoRA leaf and the loss a step (the count of valid tokens
goes first, alone). The bytes handed to ``all_reduce`` are counted in
:attr:`DataParallel.bytes_all_reduced`; those of the model axis in
:attr:`ModelParallel.bytes_model_axis`.

The ranks of one model group take the same rows (their data index picks
them). The model axis runs the dense family (``api/spec.py`` refuses the
others, ``ROADMAP.md`` §1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.sharding import MODEL, model_dim
from repro_torch.tree import tree_leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Ranks laid out over named axes: ``ranks`` is an int array of shape
    ``[sizes of axis_names]``; ``model`` is the last axis."""
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

    @property
    def model_size(self) -> int:
        return self.shape.get(MODEL, 1)

    def coords(self, r: int) -> Tuple[int, int]:
        """(data index, model index) of rank ``r``: its row of the
        flattened (pod x data) axes and its column of ``model``."""
        flat = self.rank_list.index(r)
        return flat // self.model_size, flat % self.model_size

    def data_ranks(self, model_index: int) -> List[int]:
        """The ranks of one data axis: those at ``model_index``."""
        return self.rank_list[model_index::self.model_size]

    def model_ranks(self, data_index: int) -> List[int]:
        """The ranks of one model axis: those at ``data_index``."""
        m = self.model_size
        return self.rank_list[data_index * m:(data_index + 1) * m]


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
#: whole world, so every rank asks for the same groups in the same order
_GROUPS: Dict[Tuple[int, ...], object] = {}


def group_over(ranks: Sequence[int]):
    """The process group over ``ranks``, or None when there is no process
    group (one rank in a process of its own). The world group when
    ``ranks`` is the whole world in order; else made once by
    ``dist.new_group``, which every rank of the world must call alike."""
    ranks = tuple(int(r) for r in ranks)
    if not dist.is_initialized():
        if len(ranks) > 1:
            raise RuntimeError(f"a mesh of {len(ranks)} ranks needs a "
                               "process group; torch.distributed is not "
                               "initialized")
        return None
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def group_of(mesh: DeviceMesh):
    """The process group over all of ``mesh``'s ranks (:func:`group_over`)."""
    return group_over(mesh.rank_list)


def mesh_groups(mesh: DeviceMesh):
    """(mesh group, this rank's data-axis group, its model-axis group).
    Collective: every rank of the world makes every group of the mesh, in
    one order (the whole mesh, the data axes by model index, the model
    axes by data index); a rank off the mesh gets None for its axes."""
    whole = group_of(mesh)
    data = [group_over(mesh.data_ranks(m)) if mesh.data_size > 1 else None
            for m in range(mesh.model_size)]
    model = [group_over(mesh.model_ranks(i)) if mesh.model_size > 1
             else None for i in range(mesh.data_size)]
    me = rank()
    if me not in mesh.rank_list:
        return whole, None, None
    di, mi = mesh.coords(me)
    return whole, data[mi], model[di]


def rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def place_tree(tree, mesh: DeviceMesh, specs):
    """This rank's slice of each leaf of a whole ``tree``: along the dim
    its spec (``launch/sharding.py``) puts on ``model``, the model index's
    part, copied out so that the whole leaf can be freed; other leaves as
    they are. Local: nothing is sent."""
    if mesh.model_size == 1 or specs is None:
        return tree
    me = rank()
    if me not in mesh.rank_list:
        return tree
    mi, m = mesh.coords(me)[1], mesh.model_size

    def put(leaf, spec):
        d = model_dim(spec)
        if d is None or not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.shape[d] % m:
            raise ValueError(f"a dim of {leaf.shape[d]} does not divide "
                             f"over a model axis of {m}")
        n = leaf.shape[d] // m
        return leaf.narrow(d, mi * n, n).clone(
            memory_format=torch.contiguous_format)

    return tree_map(put, tree, specs)


def reshard_tree(tree, mesh: DeviceMesh, specs=None, group=None):
    """Placement of a whole ``tree`` on ``mesh``: every tensor leaf
    broadcast from the mesh's first rank (in place on the other members,
    whose trees must have the same shapes), then, with ``specs``, sliced
    by :func:`place_tree`. None and non-tensor leaves pass through. On a
    mesh of one rank nothing moves. Call it on every member of the mesh;
    :func:`gather_tree` inverts it bit for bit."""
    if mesh.size == 1:
        return tree
    group = group if group is not None else group_of(mesh)
    src = mesh.rank_list[0]

    def put(leaf):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, src=src, group=group)
        return leaf

    return place_tree(tree_map(put, tree), mesh, specs)


def gather_tree(tree, mesh: DeviceMesh, specs, group):
    """The whole tree from this rank's slices: each leaf whose spec puts a
    dim on ``model`` all-gathered along it over this rank's model axis
    (``group``: :func:`mesh_groups`' third). Call it on every member of
    the mesh."""
    if mesh.model_size == 1 or specs is None:
        return tree
    tp = ModelParallel(mesh, group)

    def get(leaf, spec):
        d = model_dim(spec)
        if d is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return tp.all_gather(leaf, d)

    return tree_map(get, tree, specs)


def rebalance_batch(global_batch: int, old_hosts: int, new_hosts: int) -> int:
    """Per-host batch after a resize, keeping the global batch invariant."""
    if new_hosts < 1 or global_batch % new_hosts != 0:
        raise ValueError(
            f"global batch {global_batch} cannot be kept invariant over "
            f"{new_hosts} hosts — choose a divisor count")
    return global_batch // new_hosts


def predicted_grad_sync_bytes(n_trainable: int, mesh_axes: Dict[str, int],
                              dtype_bytes: int = 4) -> int:
    """Analytic lower bound on the per-rank data-parallel gradient-sync
    payload of one train step (``repro.roofline.analysis``): every
    trainable element is reduced over the data axes once a step, and a
    rank holds at least ``1/model`` of the elements (model-sharded LoRA
    factors), so ``bytes >= n_trainable * dtype_bytes / model`` when the
    data axes hold more than one rank; with a single data shard there is
    nothing to sync (0). :attr:`DataParallel.bytes_all_reduced` is held to
    it."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_axes.get(a, 1)
    if dp <= 1:
        return 0
    return (n_trainable * dtype_bytes) // max(mesh_axes.get(MODEL, 1), 1)


class DataParallel:
    """The data axis of ``mesh`` for this rank: the gradient and loss sync
    of every engine's step (see the module docstring). ``group`` is this
    rank's data-axis group (:func:`mesh_groups`); over a mesh with a model
    axis the ranks of one model group sync over their own data axes, each
    with the rows of its data index."""

    def __init__(self, mesh: DeviceMesh, group=None):
        self.mesh = mesh
        self.group = group
        self.size = mesh.data_size
        me = rank()
        if me not in mesh.rank_list:
            raise ValueError(f"rank {me} is not on the mesh "
                             f"{mesh.rank_list}")
        self.index = mesh.coords(me)[0]
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


_HALF = (torch.bfloat16, torch.float16)


class ModelParallel:
    """The model axis of ``mesh`` for this rank: its index on the axis and
    the collectives over its model group (``group``, :func:`mesh_groups`).
    Every collective counts the bytes of the buffer it hands over in
    :attr:`bytes_model_axis`.

    A sum of a bf16 or f16 tensor (all-reduce, reduce-scatter) runs in
    f32: the partials are widened, summed and rounded once, as the
    single-process kernels sum in f32 and round once (a bf16 sum would
    round again at every rank's addition). The collectives are the
    process group's own: ``gloo`` takes CPU tensors and, in the PyTorch
    of the card's machine (2.11), CUDA tensors in all four
    (``chip_smoke.py`` step 23 records it), ``nccl`` CUDA tensors; a
    group that refuses one raises. The bytes counted are those of the
    buffer handed over: a reduce-scatter's whole input, an all-gather's
    part."""

    def __init__(self, mesh: DeviceMesh, group=None):
        self.mesh = mesh
        self.group = group
        self.size = mesh.model_size
        me = rank()
        if me not in mesh.rank_list:
            raise ValueError(f"rank {me} is not on the mesh "
                             f"{mesh.rank_list}")
        self.index = mesh.coords(me)[1]
        #: bytes handed to the model axis's collectives since the last reset
        self.bytes_model_axis = 0

    def _hand(self, buf: torch.Tensor) -> None:
        self.bytes_model_axis += buf.numel() * buf.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op`` "max") of ``t`` over the axis, in ``t``'s
        dtype; ``t`` is left as it is."""
        if self.size == 1:
            return t
        wide = op == "sum" and t.dtype in _HALF
        buf = t.detach().to(torch.float32 if wide else t.dtype,
                            copy=True).contiguous()
        self._hand(buf)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return buf.to(t.dtype)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        x = t.detach().movedim(dim, 0).contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        self._hand(x)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of the sum of ``t`` over the
        axis, in ``t``'s dtype."""
        if self.size == 1:
            return t
        wide = t.dtype in _HALF
        x = t.detach().movedim(dim, 0).to(
            torch.float32 if wide else t.dtype, copy=True).contiguous()
        self._hand(x)
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out.movedim(0, dim).to(t.dtype).contiguous()
