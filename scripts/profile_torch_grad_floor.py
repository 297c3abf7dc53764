"""Readings behind the bf16 gradient checks of ``chip_smoke.py``, sound and
with faults planted in a kernel's result, over a bf16 and an nf4 frozen
base, on the models ``chip_smoke.py`` checks (random weights from seed 0,
batch 1 x seq 256). Faults wrap a kernel's Python wrapper in the bf16 calls
only and leave the source alone, so the f32 runs never see them.

``--model dense``: full-width qwen2.5-0.5b (24 layers) and
``chip_smoke.compare_grads``' distances (``_grad_runs``: the kernels, the
plain backend in bf16 and in f32); the check holds every LoRA leaf to
``GRAD_TOL`` (relative L2 from the plain bf16 gradient) and to no further
from f32 than twice the plain bf16 gradient (+1e-3). Faults in the dense
LoRA forward's result (``lora_fused``, ``lora_fused_q``, ``lora_fused_q4``):

- ``k_tail``: x @ W0 without the last 16 of K, as a K loop one m16n8k16
  step short (or one member of a K split short of its last step) would give;
- ``code_off``: the first W0 the run meets (block 0's q) one code off: every
  bf16 value one ulp up in magnitude or, over nf4, every code one up (15
  wraps to 0);
- ``h_unrounded``: h = x @ A kept in f32 where it is to be rounded to bf16
  once: the result moved by round(acc + s h @ B) - round(acc + s round(h)
  @ B), both from the plain f32 sums.

The same in the dense LoRA input gradient's result (``lora_dx``,
``lora_dx_q``, ``lora_dx_q4``): ``dx_k_tail``, g @ W0^T without the last 16
of the contraction N (the kernel itself on g zero but its last 16 columns,
B zero, taken off); ``dx_code_off``, the first W0 the run meets one code
off; ``dh_unrounded``, dh = round(s g) @ B^T kept in f32 where it is to be
rounded to bf16 once: the result moved by round(acc + dh @ A^T) -
round(acc + round(dh) @ A^T), from the plain f32 sums.

The same in the LoRA factor gradients' result (``lora_dab``):
``dab_m_tail``, dA and dB without the last 16 rows of their contraction
(the kernel itself on x and g with those rows zero), as a row loop one
m16n8k16 step short would give; ``dab_h_unrounded``, dB from h = x @ A kept
in f32 where it is to be rounded to bf16 once: dB moved by (x @ A)^T sg -
round(x @ A)^T sg, from the plain f32 sums.

``--model moe``: full-width OLMoE-1B-7B (16 layers) and
``chip_smoke.grads_moe``' pinned distances, the per-leaf cosine that
``MOE_COS_FLOOR`` holds; faults in the bf16 grouped forward over expert
stacks (``lora_grouped_gemm``, ``_gemm_q``, ``_gemm_q4``): ``k_tail`` as
above; ``swap_expert``, expert 0's tiles computed with expert 1's W0, A and
B, as a misread group id would give; ``code_off``, expert 0's W0 one code
off as above. The same three in the bf16 grouped input gradient
(``lora_grouped_dx``, ``_dx_q``, ``_dx_q4``): ``dx_k_tail``, g @ W0^T
without the last 16 of the contraction N (the kernel itself on g zero but
its last 16 columns, B zero, taken off); ``dx_swap_expert``;
``dx_code_off``. The same in the grouped factor gradients
(``lora_grouped_dab``): ``dab_m_tail`` (each tile's last 16 rows),
``dab_h_unrounded`` (per tile, with its group's A) and
``dab_swap_expert`` (expert 0's tiles added to expert 1's dA and dB).

``--model gemma3``: full-width Gemma3-12B cut to one group (5 local
layers of window 1,024, 1 global) at batch 1 x seq 2048 with B at
``chip_smoke.b_scale_for``, as ``chip_smoke.py``'s step 19 (d) draws it,
and the distance that ``CATALOG_F32_GRAD_TOL`` holds: per leaf, the f32
kernels' gradient from the plain f32 one. Faults go into the f32 calls of
the flash wrappers (head dim 256), so the bf16 runs never see them:
``window_off``, the forward and both backward kernels called with window 0
(a mask that ignores the local layers' window); ``dq_d_tail``, dq's last
16 of D zero (a staging of D in passes that drops its last columns);
``dkv_d_tail``, dk's and dv's last 16 of D zero. Base ``none`` only.

It uses the ``chip_smoke`` and ``repro_torch`` found on the path, so one
call can read two checkouts in turns:

    PYTHONPATH=src:. python scripts/profile_torch_grad_floor.py \\
        [--model dense|moe|gemma3|both] [--faults none,dx_k_tail,...] \\
        [--bases none,nf4] [--label L]

Prints one JSON line per model, base and fault, as each is read, then one
with the limits and the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess

import torch

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_fused as lf
from repro_torch.kernels import lora_grouped as lg
from repro_torch.kernels import lora_pack4 as lp4
from repro_torch.kernels import lora_quant as lq
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib

DENSE_ARCH = "qwen2.5-0.5b"
TAIL = 16
# the bf16 wrappers faults go into: (module, wrapper, position of B among
# the arguments after the activations, x or g; gid follows B, scale is
# passed last, positionally)
WRAPPERS = {
    "dense": ((lf, "lora_fused", 2), (lq, "lora_fused_q", 3),
              (lp4, "lora_fused_q4", 3)),
    "dense_dx": ((lf, "lora_dx", 2), (lq, "lora_dx_q", 3),
                 (lp4, "lora_dx_q4", 3)),
    "moe": ((lg, "lora_grouped_gemm", 2), (lg, "lora_grouped_gemm_q", 3),
            (lg, "lora_grouped_gemm_q4", 3)),
    "moe_dx": ((lg, "lora_grouped_dx", 2), (lg, "lora_grouped_dx_q", 3),
               (lg, "lora_grouped_dx_q4", 3)),
    "dense_dab": ((lf, "lora_dab", 2),),
    "moe_dab": ((lg, "lora_grouped_dab", 2),),
    "flash": ((fa, "flash_attention_fwd", None), (fa, "flash_bwd_dq", None),
              (fa, "flash_bwd_dkv", None)),
    "flash_dq": ((fa, "flash_bwd_dq", None),),
    "flash_dkv": ((fa, "flash_bwd_dkv", None),),
}


def _replace(args, i, v):
    return args[:i] + (v,) + args[i + 1:]


def k_tail(fn, x, args, kw, b_at, state):
    """The result less round(x[:, -TAIL:] @ W0[-TAIL:]) (times the scale),
    which the kernel itself gives for x zero but its last TAIL columns and
    B zero. In dx, x is g and the contraction N: the result less
    round(g[:, -TAIL:] @ W0[:, -TAIL:]^T), dh being zero with B."""
    xt = torch.zeros_like(x)
    xt[:, -TAIL:] = x[:, -TAIL:]
    tail = fn(xt, *_replace(args, b_at, torch.zeros_like(args[b_at])), **kw)
    return (fn(x, *args, **kw).float() - tail.float()).to(x.dtype)


def swap_expert(fn, x, args, kw, b_at, state):
    gid = args[b_at + 1]
    return fn(x, *_replace(args, b_at + 1, torch.where(gid == 0, 1, gid)),
              **kw)


def _one_code_off(w):
    w = w.clone()
    if w.dtype == torch.bfloat16:
        w.copy_((w.view(torch.int16) + 1).view(torch.bfloat16))
    else:  # packed nf4 codes
        w.copy_(((w + 1) & 15) | ((((w >> 4) + 1) & 15) << 4))
    return w


def code_off(fn, x, args, kw, b_at, state):
    """Grouped: expert 0's W0 one code off. Dense: the first W0 the run
    meets (every later call on it, remat's included) one code off."""
    w = args[0]
    if w.dim() == 3:
        w = w.clone()
        w[0] = _one_code_off(w[0])
    else:
        state.setdefault("ptr", w.data_ptr())
        if w.data_ptr() != state["ptr"]:
            return fn(x, *args, **kw)
        w = _one_code_off(w)
    return fn(x, w, *args[1:], **kw)


def _acc(x, w, args, kw):
    """x @ w(W0) in f32, times the scale S over a quantized base (the
    dense forward's acc * S before the LoRA term)."""
    if w.dtype == x.dtype:
        return x.float() @ w.float()
    s = args[1].float()
    if w.dtype == torch.int8:
        return (x.float() @ w.to(x.dtype).float()) * s
    dq = lp4.unpack_weights(w, kw.get("method", "int4"), x.dtype, x.shape[1])
    return (x.float() @ dq.float()) * s


def h_unrounded(fn, x, args, kw, b_at, state):
    """The result moved by what keeping h in f32 would change, from the
    plain f32 sums: round(acc + s h @ B) - round(acc + s round(h) @ B)."""
    a, b, scale = args[b_at - 1], args[b_at], args[b_at + 1]
    acc = _acc(x, args[0], args, kw)
    h = x.float() @ a.float()
    y_r = (acc + scale * (h.to(x.dtype).float() @ b.float())).to(x.dtype)
    y_u = (acc + scale * (h @ b.float())).to(x.dtype)
    y = fn(x, *args, **kw)
    return (y.float() + (y_u.float() - y_r.float())).to(x.dtype)


def dh_unrounded(fn, g, args, kw, b_at, state):
    """dx: the result moved by what keeping dh = round(s g) @ B^T in f32
    would change, from the plain f32 sums: round(acc + dh @ A^T) -
    round(acc + round(dh) @ A^T), acc = g @ W0^T (g scaled by round(S)
    over codes)."""
    w, a, b, scale = args[0], args[b_at - 1], args[b_at], args[b_at + 1]
    if w.dtype == g.dtype:
        acc = g.float() @ w.float().T
    else:
        wt = w.to(g.dtype) if w.dtype == torch.int8 else lp4.unpack_weights(
            w, kw.get("method", "int4"), g.dtype, a.shape[0])
        acc = (g * args[1].to(g.dtype)).float() @ wt.float().T
    dh = (scale * g).float() @ b.float().T
    y_r = (acc + dh.to(g.dtype).float() @ a.float().T).to(g.dtype)
    y_u = (acc + dh @ a.float().T).to(g.dtype)
    y = fn(g, *args, **kw)
    return (y.float() + (y_u.float() - y_r.float())).to(g.dtype)


def _tail_rows(x, kw):
    """The rows of dA's and dB's contraction that ``dab_m_tail`` drops:
    the last TAIL of x's rows, or of each tile of ``bm`` rows (grouped)."""
    bm = kw.get("bm", x.shape[0])
    off = torch.arange(x.shape[0], device=x.device) % bm
    return off >= bm - TAIL


def dab_m_tail(fn, x, args, kw, b_at, state):
    """dA and dB without the last TAIL rows of their contraction (each
    tile's, grouped): the kernel itself on x and g with those rows zero,
    whose h, dh and products are then zero."""
    drop = _tail_rows(x, kw)[:, None]
    g = args[0]
    return fn(x.masked_fill(drop, 0), g.masked_fill(drop, 0), *args[1:],
              **kw)


def dab_h_unrounded(fn, x, args, kw, b_at, state):
    """dB moved by what keeping h = x @ A in f32 would change, from the
    plain f32 sums: h^T sg - round(h)^T sg (per tile with its group's A,
    grouped; a tile with no group adds nothing)."""
    g, a, scale = args[0], args[b_at - 1], args[-1]
    sg = (scale * g.float()).to(x.dtype).float()
    if "bm" in kw:
        gid, bm = args[b_at + 1], kw["bm"]
        T, (E, K, r), N = gid.numel(), a.shape, g.shape[1]
        e, ok = lg._tile_groups(gid, E)
        h = x.reshape(T, bm, K).float() @ a[e].float()
        sgt = sg.reshape(T, bm, N)
        diff = h.mT @ sgt - h.to(x.dtype).float().mT @ sgt
        move = torch.zeros((E, r, N), device=x.device).index_add_(
            0, e, diff * ok.float()[:, None, None])
    else:
        h = x.float() @ a.float()
        move = h.T @ sg - h.to(x.dtype).float().T @ sg
    da, db = fn(x, *args, **kw)
    return da, (db.float() + move).to(db.dtype)


def window_off(fn, q, args, kw, b_at, state):
    """A flash kernel called with window 0: every key up to the query's
    position, where a local layer sees only the last 1,024."""
    return fn(q, *args, **{**kw, "window": 0})


def d_tail(fn, q, args, kw, b_at, state):
    """A flash backward kernel's results with their last TAIL columns of
    D zero."""
    out = fn(q, *args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    for t in outs:
        t[..., -TAIL:] = 0
    return out


# each model's faults: (fault, the WRAPPERS it goes into)
FAULTS = {"dense": {"k_tail": (k_tail, "dense"),
                    "code_off": (code_off, "dense"),
                    "h_unrounded": (h_unrounded, "dense"),
                    "dx_k_tail": (k_tail, "dense_dx"),
                    "dx_code_off": (code_off, "dense_dx"),
                    "dh_unrounded": (dh_unrounded, "dense_dx"),
                    "dab_m_tail": (dab_m_tail, "dense_dab"),
                    "dab_h_unrounded": (dab_h_unrounded, "dense_dab")},
          "moe": {"k_tail": (k_tail, "moe"),
                  "swap_expert": (swap_expert, "moe"),
                  "code_off": (code_off, "moe"),
                  "dx_k_tail": (k_tail, "moe_dx"),
                  "dx_swap_expert": (swap_expert, "moe_dx"),
                  "dx_code_off": (code_off, "moe_dx"),
                  "dab_m_tail": (dab_m_tail, "moe_dab"),
                  "dab_h_unrounded": (dab_h_unrounded, "moe_dab"),
                  "dab_swap_expert": (swap_expert, "moe_dab")},
          "gemma3": {"window_off": (window_off, "flash"),
                     "dq_d_tail": (d_tail, "flash_dq"),
                     "dkv_d_tail": (d_tail, "flash_dkv")}}


def planted(model, fault):
    """Patch every wrapper that ``model``'s fault ``fault`` goes into, in
    its bf16 calls (its f32 calls for gemma3); returns the function that
    restores them."""
    fault, target = FAULTS[model][fault]
    state, saved = {}, []
    dtype = torch.float32 if model == "gemma3" else torch.bfloat16

    def wrap(fn, b_at):
        @functools.wraps(fn)  # the wrapper counts launches on its name
        def faulty(x, *args, **kw):
            if x.dtype != dtype:
                return fn(x, *args, **kw)
            return fault(fn, x, args, kw, b_at, state)
        return faulty
    for mod, name, b_at in WRAPPERS[target]:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrap(fn, b_at))
    return lambda: [setattr(m, n, f) for m, n, f in saved]


def _params(cfg, quantize):
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cs._with_b(torch, model_lib.init_params(
        cfg, generator=gen, quantize=None if quantize == "none"
        else quantize), gen)


def dense_reading(cfg, batch, quantize, fault):
    """The dense check's distances (``compare_grads`` unchecked): per leaf
    kernels vs plain bf16 (relative L2 and cosine), and how far each leaf
    is from the check's second bound, kernels vs f32 over twice plain bf16
    vs f32 + 1e-3 (a pass needs 1 or less)."""
    params = _params(cfg, quantize)
    restore = planted("dense", fault) if fault else (lambda: None)
    try:
        d = cs._distances(torch, *cs._grad_runs(torch, cfg, params, batch,
                                                quantize))
    finally:
        restore()
    del params
    cs._release(torch)
    leaves = d["leaves"]
    ratio = {p: e["kernels_vs_f32"] / (2 * e["plain_vs_f32"] + 1e-3)
             for p, e in leaves.items()}
    worst = max(e["kernels_vs_plain"] for e in leaves.values())
    return {"worst_rel": worst, "worst_f32_ratio": max(ratio.values()),
            "passes": worst <= cs.GRAD_TOL and max(ratio.values()) <= 1.0,
            "min_cos": min(e["cos"]["kernels_vs_plain"]
                           for e in leaves.values()),
            "plain_vs_f32_worst": d["worst"]["plain_vs_f32"],
            "leaves": len(leaves), "loss": d["loss"],
            "rel_per_leaf": {p: e["kernels_vs_plain"]
                             for p, e in leaves.items()}}


def moe_reading(cfg, batch, quantize, fault):
    """The full-depth MoE check's pinned cosines (``grads_moe``)."""
    params = _params(cfg, quantize)
    restore = planted("moe", fault) if fault else (lambda: None)
    try:
        d = cs.grads_moe(torch, moe_lib, cfg, params, batch,
                         quantize=quantize)
    finally:
        restore()
    del params
    cs._release(torch)
    cos = [e["cos"]["kernels_vs_plain"] for e in d["leaves"].values()]
    return {"min_cos": min(cos), "max_cos": max(cos),
            "passes": min(cos) >= cs.MOE_COS_FLOOR,
            "worst_rel": d["worst"]["kernels_vs_plain"],
            "f32_kernels_worst_rel": d["worst"]["kernels_f32_vs_f32"],
            "leaves": len(cos), "loss": d["loss"],
            "cos_per_leaf": {p: e["cos"]["kernels_vs_plain"]
                             for p, e in d["leaves"].items()}}


def gemma3_reading(cfg, batch, quantize, fault):
    """Step 19 (d)'s distances (``compare_grads`` unchecked, with the f32
    kernels): per leaf, the f32 kernels' gradient from the plain f32 one
    (relative L2), which ``CATALOG_F32_GRAD_TOL`` holds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cs._with_b(torch, model_lib.init_params(cfg, generator=gen),
                        gen, cs.b_scale_for(cfg))
    restore = planted("gemma3", fault) if fault else (lambda: None)
    try:
        d = cs._distances(torch, *cs._grad_runs(
            torch, cfg, params, batch, quantize, f32_kernels=True))
    finally:
        restore()
    del params
    cs._release(torch)
    rel = {p: e["kernels_f32_vs_f32"] for p, e in d["leaves"].items()}
    return {"f32_kernels_worst_rel": max(rel.values()),
            "f32_kernels_least_rel": min(rel.values()),
            "passes": max(rel.values()) <= cs.CATALOG_F32_GRAD_TOL,
            "passes_at_grad_tol": max(rel.values()) <= cs.GRAD_TOL,
            "bf16_worst_rel": d["worst"]["kernels_vs_plain"],
            "leaves": len(rel), "loss": d["loss"], "rel_per_leaf": rel}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("dense", "moe", "gemma3", "both"),
                    default="both")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to read (none: sound); "
                         "default every fault of the model")
    ap.add_argument("--bases", default="none,nf4",
                    help="comma-separated frozen-base formats to read over")
    ap.add_argument("--label", default="", help="a name for this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_grad_floor: no CUDA card is visible")
    only = set(args.faults.split(",")) if args.faults else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    models = ("dense", "moe") if args.model == "both" else (args.model,)
    for model in models:
        seq = cs.PAPER_SEQ
        if model == "gemma3":
            cfg = dataclasses.replace(get_config(cs.GEMMA_ARCH),
                                      n_layers=cs.GEMMA_GROUP)
            seq = cs.GEMMA_SEQ
        else:
            cfg = get_config(DENSE_ARCH if model == "dense" else cs.MOE_ARCH)
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
            make_batch_iterator(cfg.vocab, seq, cs.PAPER_BATCH,
                                seed=0)).items()}
        read = {"dense": dense_reading, "moe": moe_reading,
                "gemma3": gemma3_reading}[model]
        bases = "none" if model == "gemma3" else args.bases
        for base in bases.split(","):
            for fault in [None, *FAULTS[model]]:
                if only is not None and (fault or "none") not in only:
                    continue
                print(json.dumps({"label": args.label, "model": model,
                                  "layers": cfg.n_layers, "base": base,
                                  "fault": fault or "none",
                                  **read(cfg, batch, base, fault)}),
                      flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "grad_tol": cs.GRAD_TOL,
                      "cos_floor": cs.MOE_COS_FLOOR,
                      "f32_grad_tol": cs.CATALOG_F32_GRAD_TOL,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
