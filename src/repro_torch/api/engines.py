"""The port's engine registrations (``repro.api.engines``).

Importing this module (done lazily by the registry) registers:

* ``mesp``: the hand-derived structured backward (paper §4);
* ``mesp_cuda``: the same rules through the CUDA kernels (the reference's
  ``mesp_pallas``);
* ``mebp``: autograd of the plain forwards (paper §3.3 baseline);
* ``store_h``: MeSP with ``h = x @ A`` saved (paper Table 5 ablation);
* ``mesp_seq``: the paper's §4.3 loop, SGD applied per block at once;
* through ``repro_torch.zo.engines``, the zeroth-order family: ``mezo``
  (§3.2) and its sampler variants ``mezo_sparse``, ``mezo_lowrank``,
  ``mezo_block`` and ``mezo_avg4``.

``ENGINES`` maps each engine to the ExecutionPolicy backend it runs under;
a ZO engine, which has no backward, maps to ``plain`` (the reference's
``TrainSpec.policy()``).
"""
from __future__ import annotations

from repro_torch.api.registry import list_engines, register_engine


def _grad_builder(spec, cfg, opt, policy):
    """Step-builder of the engines that are ``mesp.value_and_grad`` under
    one backend, followed by the optimizer; under a data axis
    (``policy.dp``) the LoRA gradients and the loss are all-reduced over it
    in between."""
    from repro_torch.core import mesp

    def step(params, opt_state, batch):
        loss, grads = mesp.value_and_grad(params, cfg, batch, policy=policy)
        if policy.dp is not None:
            loss, grads = policy.dp.reduce(loss, grads, batch["labels"])
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def _grad_vag(params, cfg, batch, *, policy, seed=None):
    from repro_torch.core import mesp
    return mesp.value_and_grad(params, cfg, batch, policy=policy)


register_engine(
    "mesp", backend="structured", paper="§4", value_and_grad=_grad_vag,
    description="MeSP: hand-derived structured backward (h recomputed)")(
    _grad_builder)

register_engine(
    "mesp_cuda", backend="cuda", paper="§4 + kernels",
    value_and_grad=_grad_vag,
    description="MeSP with the structured rules in CUDA kernels written "
                "for Hopper (LoRA, RMSNorm, flash attention); their plain "
                "versions on CPU tensors")(_grad_builder)

register_engine(
    "mebp", backend="plain", paper="§3.3", value_and_grad=_grad_vag,
    description="MeBP baseline: per-block checkpointing + autograd")(
    _grad_builder)

register_engine(
    "store_h", backend="store_h", paper="Table 5", value_and_grad=_grad_vag,
    description="MeSP ablation: h = x@A stored instead of recomputed")(
    _grad_builder)


@register_engine(
    "mesp_seq", backend="structured", paper="§4.3", value_and_grad=_grad_vag,
    description="MeSP, paper §4.3 verbatim: reverse loop over blocks, SGD "
                "applied at once per block (dense family)")
def _mesp_seq_builder(spec, cfg, opt, policy):
    from repro_torch.core import mesp

    if cfg.family != "dense" or cfg.window_pattern:
        raise ValueError(
            "engine mesp_seq (paper §4.3) supports dense, non-patterned "
            f"architectures only; got family={cfg.family!r}, "
            f"window_pattern={cfg.window_pattern!r}")
    if spec.optimizer != "sgd":
        raise ValueError(
            "engine mesp_seq applies immediate per-block SGD (paper §4.3); "
            f"--optimizer {spec.optimizer!r} is not representable")
    lr = spec.lr

    def step(params, opt_state, batch):
        params, loss = mesp.sequential_train_step(params, cfg, batch, lr,
                                                  policy=policy)
        return params, {**opt_state, "step": opt_state["step"] + 1}, loss

    return step


# the zeroth-order engines register themselves, one per sampler x queries
from repro_torch.zo import engines as _zo_engines  # noqa: E402,F401

#: engine -> ExecutionPolicy backend
ENGINES = {e.name: e.backend or "plain" for e in list_engines()}
