"""The SPSA estimator over any sampler (``repro.zo.estimator``, paper §3.2,
generalised).

Two forwards at ``θ ± ε z`` give the projected gradient ``(L₊ − L₋)/2ε``,
which scales the regenerated ``z`` as the estimate; with ``queries=k`` the
estimate is the mean over k probes. Every probe forward runs under
``torch.no_grad()``, so no graph and no saved tensor exists, and ``z`` is
regenerated from its seed at each of its three uses (+ε, −ε, the
gradient) and never held across the forwards (``zo/samplers.py``).

Seeds: one query uses ``seed`` itself; with ``queries=k > 1`` query ``q``
uses ``samplers.fold_in(seed, q)`` for q = 0..k-1 (splitmix64 of the pair),
so a step's probes are a function of its seed alone.

``spsa_grad_from_loss`` takes any scalar loss of the trainable tree;
``spsa_grad`` binds it to the model's LoRA split and is what the ``mezo*``
engines and the ``core.mezo`` shim call.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import PLAIN, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map
from repro_torch.zo.samplers import DenseSampler, PerturbationSampler, fold_in


def _map2(f, train, z):
    return tree_map(lambda t, zi: None if t is None else f(t, zi), train, z)


def perturb(train, z, eps_signed: float):
    """θ + ε·z leafwise (ε may be negative), out of place: the caller keeps
    ``train``, so no inverse pass over mutated parameters is needed."""
    return _map2(lambda p, zi: p + eps_signed * zi, train, z)


@torch.no_grad()
def spsa_grad_from_loss(loss_fn, train, seed: int, *,
                        sampler: PerturbationSampler, eps: float = 1e-3,
                        queries: int = 1):
    """(mean loss, SPSA gradient estimate over ``train``) for any scalar
    ``loss_fn(train)``; ``queries`` probes are averaged."""
    if queries < 1:
        raise ValueError(f"queries must be >= 1, got {queries}")
    seeds = [seed] if queries == 1 else [fold_in(seed, q)
                                         for q in range(queries)]
    loss_acc = grad_acc = None
    for s in seeds:
        l_plus = loss_fn(perturb(train, sampler.sample(s, train), +eps))
        l_minus = loss_fn(perturb(train, sampler.sample(s, train), -eps))
        proj = (l_plus - l_minus) / (2.0 * eps)
        g = _map2(lambda p, zi: proj.to(p.dtype) * zi, train,
                  sampler.sample(s, train))
        loss = 0.5 * (l_plus + l_minus)
        if grad_acc is None:
            loss_acc, grad_acc = loss, g
        else:
            loss_acc = loss_acc + loss
            grad_acc = _map2(torch.add, grad_acc, g)
    if queries > 1:
        inv = 1.0 / queries
        loss_acc = loss_acc * inv
        grad_acc = _map2(lambda a, _: a * inv, grad_acc, grad_acc)
    return loss_acc, grad_acc


def spsa_grad(params, cfg: ArchConfig, batch: dict, seed: int, *,
              sampler: PerturbationSampler | None = None, eps: float = 1e-3,
              queries: int = 1, policy: ExecutionPolicy = PLAIN,
              loss_reduce=None):
    """ZO gradient estimate over the LoRA params of the full model: (loss,
    grads with the params' nesting, None at frozen leaves). ``policy``
    selects the probe forwards' regime (no backward ever runs): ``plain``
    is the MeZO setting, ``cuda`` runs the forward kernels.
    ``loss_reduce`` maps each probe's local loss to the global one (the
    data axis's all-reduce)."""
    from repro_torch.models import model as model_lib

    sampler = sampler if sampler is not None else DenseSampler()
    train, frozen = model_lib.split_params(params)

    def loss(t):
        out = model_lib.loss_fn(model_lib.merge_params(t, frozen), cfg,
                                batch, policy=policy)
        return out if loss_reduce is None else loss_reduce(out)

    return spsa_grad_from_loss(loss, train, seed, sampler=sampler, eps=eps,
                               queries=queries)


def train_step(params, cfg: ArchConfig, batch: dict, seed: int, lr: float,
               eps: float = 1e-3, *,
               sampler: PerturbationSampler | None = None, queries: int = 1):
    """One plain-SGD ZO step (the ``core.mezo.train_step`` contract).
    Returns (params, loss)."""
    from repro_torch.optim.optimizers import sgd_apply

    loss, grads = spsa_grad(params, cfg, batch, seed, sampler=sampler,
                            eps=eps, queries=queries)
    return sgd_apply(params, grads, lr), loss
