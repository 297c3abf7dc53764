"""repro_torch.zo: zeroth-order estimators and gradient-quality probes
(``repro.zo``).

* estimators: seed-replay perturbation samplers (dense, sparse, low-rank,
  blockwise; ``zo/samplers.py``) and the SPSA estimator they plug into
  (``zo/estimator.py``); ``zo/engines.py`` registers each variant as a
  ``mezo*`` engine;
* diagnostics: ``zo/gradquality.py`` scores any registered engine's
  estimate against the exact MeSP gradient (the paper's §5.6 cosine ≈
  0.001).
"""
from repro_torch.zo.estimator import (perturb, spsa_grad, spsa_grad_from_loss,
                                      train_step)
from repro_torch.zo.samplers import (SAMPLERS, BlockwiseSampler, DenseSampler,
                                     LowRankSampler, PerturbationSampler,
                                     SparseSampler, fold_in, get_sampler,
                                     register_sampler, sampler_names)

__all__ = [
    "BlockwiseSampler", "DenseSampler", "LowRankSampler",
    "PerturbationSampler", "SAMPLERS", "SparseSampler", "fold_in",
    "get_sampler", "perturb", "register_sampler", "sampler_names",
    "spsa_grad", "spsa_grad_from_loss", "train_step",
]
