"""Perturbation samplers (``repro.zo.samplers``): the pluggable half of the
ZO estimator.

A sampler decides the distribution of the SPSA probe direction ``z`` over
the trainable (LoRA) tree. Every sampler is **seed-replay based**: ``z`` is
a function of ``(seed, train)`` alone, drawn from a ``torch.Generator``
made on the leaves' device from the int ``seed``, and is regenerated
wherever it is needed (perturb +ε, perturb −ε, the gradient) instead of
being stored, which gives MeZO-style methods their inference-level memory.
Two calls of ``sample(seed, train)`` with one seed give the same bits, on
the CPU and on the card. The draws differ from ``jax.random``'s; the
deterministic parts (masks, scales, the layer pick's arithmetic) are the
reference's.

Built-ins:

* ``dense``: z ~ N(0, I) over every LoRA coordinate (vanilla MeZO SPSA,
  paper §3.2);
* ``sparse``: dense z masked to the top-ρ fraction of each leaf's
  coordinates by ``|w|`` (Sparse MeZO, arXiv:2402.15751), the mask
  recomputed from the parameters, never stored;
* ``lowrank``: rank-1 noise ``z = s·u vᵀ`` over each leaf's trailing two
  axes (arXiv:2410.07698), ``s`` the paired LoRA factor's RMS;
* ``blockwise``: one transformer block per probe: stacked ``[L, ...]``
  leaves masked to one shared layer index drawn from the seed, rescaled
  by √L so that ``E[zzᵀ] = I`` still holds.

Leaves are visited in sorted-key order (the reference's flatten order).
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import tree as _tree

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``(seed, data)``: splitmix64's finalizer over
    ``seed + golden · (data + 1)`` (the port's counterpart of
    ``jax.random.fold_in``)."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def leaves_with_paths(tree):
    """[(path, leaf)] of a nested dict/list in sorted-key order, None
    skipped."""
    return _tree.leaves_with_paths(tree, sort=True)


def unflatten(tree, leaves):
    """``tree``'s nesting with its non-None leaves replaced, in
    :func:`leaves_with_paths` order, by ``leaves``."""
    return _tree.unflatten(tree, leaves, sort=True)


def _generator(seed: int, leaves) -> torch.Generator:
    return torch.Generator(device=leaves[0].device).manual_seed(int(seed))


def _normal(gen, shape, like):
    return torch.randn(shape, generator=gen, device=like.device,
                       dtype=like.dtype)


@runtime_checkable
class PerturbationSampler(Protocol):
    """Deterministic probe-direction generator over the trainable tree."""

    #: registry name (also the engine-name suffix, see zo/engines.py)
    name: str

    def sample(self, seed: int, train):
        """z with the nesting, shapes and dtypes of ``train``, a function
        of ``(seed, train)``: the same bits on replay with one seed."""
        ...


class DenseSampler:
    """Vanilla MeZO/SPSA direction: z ~ N(0, I) per LoRA coordinate."""

    name = "dense"

    def sample(self, seed, train):
        leaves = [p for _, p in leaves_with_paths(train)]
        gen = _generator(seed, leaves)
        return unflatten(train, [_normal(gen, p.shape, p) for p in leaves])


def top_fraction_mask(p, rho: float):
    """``|p| >= quantile(|p|, 1 - rho)`` over the whole leaf, with
    ``jnp.quantile``'s linear interpolation done in f32 as it does it."""
    mag = p.abs().float().reshape(-1)
    n = mag.numel()
    pos = np.float32(np.float32(1.0 - rho) * np.float32(n - 1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    s = torch.sort(mag).values
    thresh = s[min(lo, n - 1)] * float(w_lo) + s[min(hi, n - 1)] * float(w_hi)
    return (mag >= thresh).reshape(p.shape)


class SparseSampler:
    """Sparse MeZO direction: dense z masked to the top-ρ |w| coordinates
    per leaf. The mask is a function of the current magnitudes, recomputed
    at every probe and never stored. A leaf whose magnitudes are all equal
    (LoRA B at init, all zero) gets a dense perturbation."""

    name = "sparse"

    def __init__(self, rho: float = 0.10):
        if not 0.0 < rho <= 1.0:
            raise ValueError(f"rho must be in (0, 1], got {rho}")
        self.rho = rho

    def sample(self, seed, train):
        leaves = [p for _, p in leaves_with_paths(train)]
        gen = _generator(seed, leaves)
        zs = [torch.where(top_fraction_mask(p, self.rho),
                          _normal(gen, p.shape, p), p.new_zeros(()))
              for p in leaves]
        return unflatten(train, zs)


def paired_factor_scales(train):
    """Per-leaf RMS (an f32 0-d tensor) of the *paired* LoRA factor: B for
    an ``a`` leaf, A for a ``b`` leaf; 1.0 where there is no pair. The
    LoRA chain rule's free magnitude signal: ``dL/dA = xᵀ δ Bᵀ`` scales
    with ``|B|`` and ``dL/dB = hᵀ δ`` with ``|A|``."""
    items = leaves_with_paths(train)
    by_parent: dict = {}
    for path, p in items:
        by_parent.setdefault(path[:-1], {})[path[-1]] = p
    scales = []
    for path, p in items:
        pair = by_parent[path[:-1]].get({"a": "b", "b": "a"}.get(path[-1]))
        scales.append(pair.float().square().mean().sqrt() if pair is not None
                      else torch.ones((), device=p.device))
    return scales


class LowRankSampler:
    """Rank-1 direction ``z = s · u vᵀ`` over each leaf's trailing axes: for
    a stacked factor [L, m, n], u ~ N(0, I) [L, m, 1] and v [L, 1, n], so
    L(m + n) random degrees of freedom in place of Lmn. ``s`` is the paired
    factor's RMS (:func:`paired_factor_scales`), or 1 with
    ``cross_scale=False``. Leaves of fewer than two axes take scaled dense
    noise."""

    name = "lowrank"

    def __init__(self, cross_scale: bool = True):
        self.cross_scale = cross_scale

    def sample(self, seed, train):
        leaves = [p for _, p in leaves_with_paths(train)]
        gen = _generator(seed, leaves)
        scales = (paired_factor_scales(train) if self.cross_scale
                  else [torch.ones((), device=p.device) for p in leaves])

        def one(p, s):
            s = s.to(p.dtype)
            if p.ndim < 2:
                return s * _normal(gen, p.shape, p)
            m, n = p.shape[-2], p.shape[-1]
            u = _normal(gen, (*p.shape[:-2], m, 1), p)
            v = _normal(gen, (*p.shape[:-2], 1, n), p)
            return s * u * v

        return unflatten(train, [one(p, s) for p, s in zip(leaves, scales)])


class BlockwiseSampler:
    """One transformer block per probe (coordinate-blockwise SPSA). One
    uniform draw selects a layer index, shared by every stacked leaf
    ``[L, ...]`` (taken modulo its own leading dim, as the reference's
    ``min(int(u · n), n - 1)``); each such leaf is masked to that index and
    rescaled by √L. Leaves of fewer than three axes are perturbed densely.
    The index stays on the device: no host sync."""

    name = "blockwise"

    def sample(self, seed, train):
        leaves = [p for _, p in leaves_with_paths(train)]
        gen = _generator(seed, leaves)
        u = torch.rand((), generator=gen, device=leaves[0].device)

        def one(p):
            z = _normal(gen, p.shape, p)
            if p.ndim < 3:
                return z
            n = p.shape[0]
            idx = (u * n).long().clamp_max(n - 1)
            mask = torch.nn.functional.one_hot(idx, n).to(p.dtype)
            return z * mask.reshape((n,) + (1,) * (p.ndim - 1)) * n ** 0.5

        return unflatten(train, [one(p) for p in leaves])


# ---------------------------------------------------------------- registry

#: name -> factory (class or callable) returning a PerturbationSampler
SAMPLERS: Dict[str, Callable[..., PerturbationSampler]] = {}


def register_sampler(factory: Callable[..., PerturbationSampler],
                     name: str | None = None):
    """Register a sampler factory; returns it, so it serves as a
    decorator."""
    key = name or factory.name
    if key in SAMPLERS:
        raise ValueError(f"sampler {key!r} is already registered")
    SAMPLERS[key] = factory
    return factory


def get_sampler(name: str, **kw) -> PerturbationSampler:
    try:
        factory = SAMPLERS[name]
    except KeyError:
        raise KeyError(f"unknown sampler {name!r}; registered: "
                       f"{sorted(SAMPLERS)}") from None
    return factory(**kw)


def sampler_names():
    return tuple(SAMPLERS)


for _cls in (DenseSampler, SparseSampler, LowRankSampler, BlockwiseSampler):
    register_sampler(_cls)
