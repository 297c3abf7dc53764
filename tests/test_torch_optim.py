"""The port's optimizers and schedules against the JAX reference (f32, CPU).

Schedules are plain functions of an int step in the port and ``jnp`` ones
in the reference: equal to 1e-7 at every step of a run past its end.
``sgd_momentum`` and ``adamw`` take the same fed gradients for 3 steps over
a tree with frozen leaves (gradient None): parameters and moments equal
at 1e-6 relative L2 per leaf (the reference computes the lr, its bias
corrections and the update in f32, the port the scalars in f64; a leaf's
element near zero after p - lr·u cancels carries the absolute rounding of
its terms), state only where a gradient is given, moments in f32 over a
bf16 parameter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

SCHEDULES = {
    "warmup_cosine": dict(peak=0.1, warmup=5, total=20),
    "warmup_cosine_floor": dict(peak=0.1, warmup=5, total=20, floor=0.01),
    "warmup_cosine_no_warmup": dict(peak=3e-4, warmup=0, total=10),
    "inverse_sqrt": dict(peak=0.1, warmup=4),
    "inverse_sqrt_no_warmup": dict(peak=2e-3, warmup=0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    kw = SCHEDULES[name]
    fn = name.split("_no_")[0].replace("_floor", "")
    got = getattr(tsched, fn)(**kw)
    want = getattr(jsched, fn)(**kw)
    for step in range(0, 26):
        j = float(want(jnp.asarray(step, jnp.int32)))
        assert isinstance(got(step), float)
        np.testing.assert_allclose(got(step), j, rtol=1e-7, atol=1e-7,
                                   err_msg=f"step {step}")


def test_constant_schedule():
    assert tsched.constant(1e-4)(7) == 1e-4


def _tree(rng):
    """A LoRA-like tree: two trainable leaves and a frozen one."""
    return {"blocks": {"q": {"a": rng.standard_normal((3, 5, 2)),
                             "b": rng.standard_normal((3, 2, 5)),
                             "w": rng.standard_normal((3, 5, 5))}},
            "final_norm": rng.standard_normal((5,))}


def _grads(rng):
    g = _tree(rng)
    g["blocks"]["q"]["w"] = None
    g["final_norm"] = None
    return g


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(
        np.asarray(tree, np.float32))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree, jnp.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


OPTS = {"sgd": {}, "sgd_momentum": {}, "sgd_momentum_beta5": {"beta": 0.5},
        "adamw": {}, "adamw_decay": {"weight_decay": 0.1, "b2": 0.99}}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_reference_over_three_steps(name):
    base = name.split("_beta")[0].replace("_decay", "")
    kw = OPTS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_grads(rng) for _ in range(3)]
    lr = tsched.warmup_cosine(0.05, 1, 3)
    t_opt = topt.make_optimizer(base, lr, **kw)
    j_opt = jopt.make_optimizer(base, jsched.warmup_cosine(0.05, 1, 3), **kw)
    tp, jp = _to_torch(params), _to_jax(params)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for g in grads:
        tp, ts = t_opt.update(_to_torch(g), ts, tp)
        jp, js = j_opt.update(_to_jax(g), js, jp)
    assert ts["step"] == int(js["step"]) == 3
    for key in ("m", "v"):
        if key not in js:
            continue
        got, want = _paths(ts[key]), _paths(js[key])
        assert got.keys() == want.keys()
        for path, w in want.items():
            if w is None:
                assert got[path] is None, path
            else:
                assert got[path].dtype == torch.float32
                assert _rel(got[path].numpy(), w) < 1e-6, f"{key}{path}"
    got, want = _paths(tp), _paths(jp)
    for path, w in want.items():
        assert _rel(got[path].numpy(), w) < 1e-6, path
    # frozen leaves come back as they were given
    assert torch.equal(tp["blocks"]["q"]["w"],
                       torch.from_numpy(params["blocks"]["q"]["w"]
                                        .astype(np.float32)))


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw"])
def test_moments_are_f32_over_bf16_params_and_cast_back(name):
    rng = np.random.default_rng(1)
    params = {k: v.to(torch.bfloat16) if v is not None else None
              for k, v in _to_torch({"a": rng.standard_normal((4, 3)),
                                     "w": rng.standard_normal((3,))}).items()}
    grads = {"a": params["a"] * 0.5, "w": None}
    opt = topt.make_optimizer(name, 1e-2)
    state = opt.init(params)
    new, state = opt.update(grads, state, params)
    assert new["a"].dtype == torch.bfloat16 and new["w"] is params["w"]
    assert state["m"]["a"].dtype == torch.float32 and state["m"]["w"] is None
    assert not torch.equal(new["a"], params["a"])


def test_make_optimizer_names():
    assert topt.OPTIMIZERS == ("sgd", "sgd_momentum", "adamw")
    with pytest.raises(ValueError, match="lion"):
        topt.make_optimizer("lion", 1e-3)
