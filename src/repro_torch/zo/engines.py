"""ZO engine registrations (``repro.zo.engines``): each sampler × queries
combination of ``_VARIANTS`` as an engine.

Imported by ``repro_torch.api.engines``; each row goes through
``register_engine``, so the train CLI's ``--engine`` choices pick the
variants up. All share the estimator of ``zo/estimator.py`` and differ in
the sampler and the number of averaged probes. ``backend=None`` (forwards
only, no backward) marks an engine as zeroth-order
(``zo/gradquality.zo_engine_names``).

A step's probe seed is ``samplers.fold_in(spec.seed, step)`` with the
optimizer's step count before the update, the counterpart of the
reference's ``fold_in(PRNGKey(seed), step)``. Under a data axis
(``policy.dp``) every rank draws the same probes and the two losses of
each probe are all-reduced (weighted by the rank's share of the valid
tokens), so every rank computes the global estimate.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.api.registry import register_engine
from repro_torch.zo import estimator
from repro_torch.zo.samplers import fold_in, get_sampler


@dataclasses.dataclass(frozen=True)
class _Variant:
    engine: str            # registered engine name
    sampler: str           # zo.samplers registry name
    sampler_kw: tuple      # sorted (key, value) pairs for the factory
    queries: int           # probes averaged per step
    paper: str
    description: str


_VARIANTS: Tuple[_Variant, ...] = (
    _Variant("mezo", "dense", (), 1, "§3.2",
             "MeZO baseline: SPSA zeroth-order estimate from two forward "
             "passes"),
    _Variant("mezo_sparse", "sparse", (("rho", 0.10),), 1,
             "§5.6 + 2402.15751",
             "Sparse-MeZO-style SPSA: probe masked to the top-10% |w| "
             "coordinates per leaf (mask recomputed, never stored)"),
    _Variant("mezo_lowrank", "lowrank", (), 1, "§5.6 + 2410.07698",
             "low-rank-structured SPSA: rank-1 u vT probe per LoRA factor, "
             "scaled by the paired factor's RMS"),
    _Variant("mezo_block", "blockwise", (), 1, "§5.6",
             "blockwise SPSA: one transformer block perturbed per probe "
             "(stacked leaves masked to a shared layer index)"),
    _Variant("mezo_avg4", "dense", (), 4, "§3.2 + §5.6",
             "MeZO with multi-query averaging: mean of 4 dense SPSA probes "
             "per step (variance / 4)"),
)


def _register(v: _Variant):
    sampler = get_sampler(v.sampler, **dict(v.sampler_kw))

    def vag(params, cfg, batch, *, policy, seed=None):
        # policy: the probe forwards' regime (no backward exists)
        return estimator.spsa_grad(params, cfg, batch,
                                   0 if seed is None else seed,
                                   sampler=sampler, queries=v.queries,
                                   policy=policy)

    @register_engine(v.engine, backend=None, paper=v.paper,
                     value_and_grad=vag, description=v.description)
    def build(spec, cfg, opt, policy):
        def step(params, opt_state, batch):
            reduce = None
            if policy.dp is not None:   # every rank draws the same probes
                w = policy.dp.weight(batch["labels"])
                reduce = lambda l: policy.dp.all_reduce(
                    [l.reshape(1)], w)[0].reshape(l.shape)
            loss, grads = estimator.spsa_grad(
                params, cfg, batch, fold_in(spec.seed, opt_state["step"]),
                sampler=sampler, queries=v.queries, policy=policy,
                loss_reduce=reduce)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss

        return step

    return build


for _v in _VARIANTS:
    _register(_v)
