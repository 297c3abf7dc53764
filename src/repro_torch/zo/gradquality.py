"""Gradient-quality probe (``repro.zo.gradquality``): any registered engine
against the exact MeSP gradient.

The paper's second headline result (§5.6, Table 3) is diagnostic: MeZO's
SPSA estimates have near-zero cosine similarity (≈ 0.001) with the true
gradients. :func:`probe` scores one estimate against a reference engine's
exact gradient on one batch (global and per-layer metrics, via
``core/gradcheck.py``); :func:`probe_over_steps` tracks the metrics over a
training trajectory (params advanced with the exact gradients between
probes) and aggregates them.

``policy``: None keeps the reference's regimes (the exact gradient under
``structured``, the estimate's probe forwards under ``plain``); a policy
runs both under it (``chip_smoke.py`` passes the ``cuda`` one).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.policy import PLAIN, STRUCTURED, ExecutionPolicy
from repro_torch.api.registry import get_engine, list_engines
from repro_torch.core import gradcheck
from repro_torch.zo.samplers import fold_in, leaves_with_paths


def zo_engine_names() -> tuple:
    """Registered zeroth-order engines: ``backend=None`` and a
    ``value_and_grad`` hook."""
    return tuple(e.name for e in list_engines()
                 if e.backend is None and e.value_and_grad is not None)


def _stacked_layers(grads) -> int:
    """Leading (layer) dim of the stacked ``blocks`` grads, 0 without."""
    if not (isinstance(grads, dict) and "blocks" in grads):
        return 0
    leaves = leaves_with_paths(grads["blocks"])
    return int(leaves[0][1].shape[0]) if leaves else 0


def _policies(policy: Optional[ExecutionPolicy]):
    return (STRUCTURED, PLAIN) if policy is None else (policy, policy)


def probe(engine: str, params, cfg, batch, seed: int, *,
          reference: str = "mesp",
          policy: Optional[ExecutionPolicy] = None) -> dict:
    """Score one gradient estimate against the reference engine's gradient.

    Returns ``{"global": {cosine_sim, sign_agree, rel_error}, "per_layer":
    [...] | None}`` (per layer for trees with a stacked ``blocks`` entry;
    with an unstacked ``block0``, row i is transformer layer i + 1)."""
    exact, est = _policies(policy)
    _, g_true = get_engine(reference).value_and_grad(params, cfg, batch,
                                                     policy=exact)
    _, g_est = get_engine(engine).value_and_grad(params, cfg, batch,
                                                 policy=est, seed=seed)
    out = {"global": {k: float(v) for k, v in
                      gradcheck.gradient_metrics(g_est, g_true).items()},
           "per_layer": None}
    n = _stacked_layers(g_true)
    if n:
        out["per_layer"] = gradcheck.per_layer_metrics(
            g_est["blocks"], g_true["blocks"], n)
    return out


def probe_over_steps(engines: Sequence[str], cfg, *, steps: int = 16,
                     warmup: int = 10, lr: float = 5e-2, seed: int = 0,
                     seq: int = 48, batch: int = 2, probes: int = 1,
                     reference: str = "mesp", per_layer: bool = True,
                     policy: Optional[ExecutionPolicy] = None
                     ) -> Dict[str, dict]:
    """Aggregate gradient-quality metrics over a training trajectory.

    The model (from ``seed``, on ``policy.device``, the CPU without one) is
    warmed up ``warmup`` SGD steps, so that LoRA B ≠ 0 (at init dL/dA is
    exactly 0); then, for each of ``steps`` steps, ``probes`` estimates of
    every engine are scored against the reference gradient on the same
    batch, and the params advance one exact SGD step. Probe seeds are
    ``fold_in(fold_in(fold_in(seed + 1, step), engine index), probe)``."""
    from repro_torch.core import mesp
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    from repro_torch.optim.optimizers import sgd_apply

    exact, est = _policies(policy)
    device = exact.device
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed))
    it = make_batch_iterator(cfg.vocab, seq, batch, seed=seed)
    next_batch = lambda: {k: torch.from_numpy(v).long().to(device)
                          for k, v in next(it).items()}
    for _ in range(warmup):
        params, _ = mesp.train_step(params, cfg, next_batch(), lr,
                                    policy=exact)

    ref = get_engine(reference)
    records: Dict[str, List[dict]] = {n: [] for n in engines}
    layer_cos: Dict[str, List[np.ndarray]] = {n: [] for n in engines}
    for t in range(steps):
        b = next_batch()
        _, g_true = ref.value_and_grad(params, cfg, b, policy=exact)
        n_stacked = _stacked_layers(g_true) if per_layer else 0
        step_seed = fold_in(seed + 1, t)
        for i, name in enumerate(engines):
            vag = get_engine(name).value_and_grad
            for pr in range(probes):
                _, g_est = vag(params, cfg, b, policy=est,
                               seed=fold_in(fold_in(step_seed, i), pr))
                m = gradcheck.gradient_metrics(g_est, g_true)
                records[name].append({k: float(v) for k, v in m.items()})
                if n_stacked:
                    rows = gradcheck.per_layer_metrics(
                        g_est["blocks"], g_true["blocks"], n_stacked)
                    layer_cos[name].append(
                        np.array([r["cosine_sim"] for r in rows]))
        # advance with the exact grads already computed for scoring
        params = sgd_apply(params, g_true, lr)

    out: Dict[str, dict] = {}
    for name in engines:
        cos = np.array([r["cosine_sim"] for r in records[name]])
        out[name] = {
            "steps": steps,
            "probes": probes,
            "cosine_mean": float(cos.mean()),
            "cosine_std": float(cos.std()),
            "cosine_sem": float(cos.std() / np.sqrt(len(cos))),
            "cosine_abs_mean": float(np.abs(cos).mean()),
            "sign_agree_mean": float(np.mean(
                [r["sign_agree"] for r in records[name]])),
            "rel_error_mean": float(np.mean(
                [r["rel_error"] for r in records[name]])),
        }
        if layer_cos[name]:
            out[name]["per_layer_cosine_mean"] = [
                float(v) for v in np.stack(layer_cos[name]).mean(axis=0)]
    return out
