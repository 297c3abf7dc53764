"""Atomic checkpointing with auto-resume (``repro.checkpoint.checkpointer``).

* **Atomicity**: writes go to ``step_XXXXXXXX.tmp/`` and are renamed to
  ``step_XXXXXXXX/`` only after a manifest with content checksums is
  fsynced. A crash mid-write can never corrupt the latest valid checkpoint.
* **Data-state**: the training-data iterator state is part of the manifest,
  so a resumed run continues the exact token stream.
* **Retention**: ``keep`` latest checkpoints are retained; older ones are
  garbage-collected after a successful save.

The layout is the reference's: one ``.npy`` per leaf, named by its path in
the tree (``params__blocks.attn.q.a.npy``), and a manifest entry per file
with its tree, path, shape, dtype and ``sha256_16`` (the first 16 hex
digits of the SHA-256 of the array's bytes). NumPy has no bfloat16, so a
bf16 leaf is saved as its raw 16-bit pattern (int16) with ``"dtype":
"bfloat16"`` in the manifest: the bytes hashed are the reference's
``arr.tobytes()`` of the same values, so equal values give equal digests.
A Python scalar leaf (the optimizer's ``step``) is saved as a 0-d array.

The manifest also records each tree's nesting (``"trees"``): dicts,
lists, ``None`` slots (an optimizer's frozen slots, or moments not made
yet) and which leaves are tensors or Python scalars. A restore rebuilds
the tree from it on the given ``device``; the templates, when given, only
need shapes and dtypes (tensors on the ``meta`` device do) and are checked
against what is restored: a leaf they hold that the checkpoint lacks
raises ``KeyError``, a shape or dtype that differs ``ValueError``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("repro_torch.ckpt")

_BF16 = "bfloat16"


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()[:16]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array written to disk, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).cpu().numpy(), _BF16
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _skeleton(tree, name: str, path: str, out: list):
    """The JSON nesting of ``tree``; collects (path, leaf) of its leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"d": {k: _skeleton(v, name, f"{path}/{k}" if path else k,
                                   out) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"l" if isinstance(tree, list) else "t": [
            _skeleton(v, name, f"{path}/{i}" if path else str(i), out)
            for i, v in enumerate(tree)]}
    fn = f"{name}__{path.replace('/', '.')}.npy"
    out.append((fn, path, tree))
    kind = "tensor" if isinstance(tree, torch.Tensor) else type(tree).__name__
    return {"f": fn, "py": kind}


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None, data_state: Optional[dict] = None,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "arrays": {}, "data_state": data_state or {},
                "extra": extra or {}, "trees": {}}
    for name, tree in (("params", params), ("opt_state", opt_state)):
        if tree is None:
            continue
        leaves: list = []
        manifest["trees"][name] = _skeleton(tree, name, "", leaves)
        for fn, key, leaf in leaves:
            arr, dtype = _to_numpy(leaf)
            np.save(os.path.join(tmp, fn), arr)
            manifest["arrays"][fn] = {
                "tree": name, "path": key, "shape": list(arr.shape),
                "dtype": dtype, "sha256_16": _digest(arr),
            }
            del arr

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish

    # retention GC
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def _list_steps(directory: str):
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return out


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _verify(directory: str, fn: str, meta: dict) -> np.ndarray:
    arr = np.load(os.path.join(directory, fn))
    if _digest(arr) != meta["sha256_16"]:
        raise IOError(f"checksum mismatch for {fn}: checkpoint corrupt")
    return arr


def _leaf(arr: np.ndarray, meta: dict, kind: str, device):
    if kind != "tensor":
        return {"int": int, "float": float, "bool": bool}[kind](arr)
    if tuple(arr.shape) != tuple(meta["shape"]):
        raise ValueError(f"{meta['path']}: shape {arr.shape} on disk, "
                         f"{meta['shape']} in the manifest")
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if meta["dtype"] == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def _rebuild(node, arrays: dict, manifest: dict, device):
    if node is None:
        return None
    if "d" in node:
        return {k: _rebuild(v, arrays, manifest, device)
                for k, v in node["d"].items()}
    if "l" in node or "t" in node:
        seq = [_rebuild(v, arrays, manifest, device)
               for v in node.get("l", node.get("t"))]
        return seq if "l" in node else tuple(seq)
    fn = node["f"]
    return _leaf(arrays.pop(fn), manifest["arrays"][fn], node["py"], device)


def _check_template(template, tree, where: str) -> None:
    """Every tensor of ``template`` is in ``tree`` with its shape and
    dtype; ``None`` in the template accepts anything."""
    if template is None:
        return
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise KeyError(f"checkpoint missing leaf {where}")
        for k, v in template.items():
            if k not in tree:
                raise KeyError(f"checkpoint missing leaf {where}/{k}")
            _check_template(v, tree[k], f"{where}/{k}")
    elif isinstance(template, (list, tuple)):
        for i, v in enumerate(template):
            _check_template(v, tree[i], f"{where}/{i}")
    elif isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or \
                tree.shape != template.shape or tree.dtype != template.dtype:
            raise ValueError(
                f"checkpoint leaf {where}: "
                f"{getattr(tree, 'dtype', type(tree))} "
                f"{tuple(getattr(tree, 'shape', ()))}, expected "
                f"{template.dtype} {tuple(template.shape)}")


def load_checkpoint(directory: str, step: int, params_template: Any = None,
                    opt_template: Any = None, *, device="cpu",
                    verify: bool = True) -> Tuple[Any, Any, dict, dict]:
    """Restore step ``step`` onto ``device``, each file's digest verified
    (``verify``), and hold the result against the templates."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    device = torch.device(device)
    out = []
    for name, template in (("params", params_template),
                           ("opt_state", opt_template)):
        node = manifest["trees"].get(name)
        if node is None:
            out.append(None)
            continue
        arrays = {fn: (_verify(d, fn, meta) if verify
                       else np.load(os.path.join(d, fn)))
                  for fn, meta in manifest["arrays"].items()
                  if meta["tree"] == name}
        tree = _rebuild(node, arrays, manifest, device)
        _check_template(template, tree, name)
        out.append(tree)
    return (out[0], out[1], manifest.get("data_state", {}),
            manifest.get("extra", {}))


def quarantine_checkpoint(directory: str, step: int) -> str:
    """Move a corrupt checkpoint dir out of the restore path by renaming it
    ``corrupt_step_XXXXXXXX`` (kept on disk for post-mortems; the
    ``step_``-prefix listing no longer sees it)."""
    src = os.path.join(directory, f"step_{step:08d}")
    dst = os.path.join(directory, f"corrupt_step_{step:08d}")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(src, dst)
    return dst


class Checkpointer:
    """Convenience wrapper bundling directory + interval + auto-resume.

    ``restore_latest`` survives corruption: a checkpoint that fails checksum
    verification (or cannot be loaded at all) is quarantined —
    renamed ``corrupt_step_*`` and recorded in ``self.quarantined`` — and
    the next-older checkpoint is tried, so one bad write never loses the
    run. Only when *every* checkpoint fails does it raise ``IOError``.
    """

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.quarantined: list = []   # (step, reason) in quarantine order

    def maybe_save(self, step: int, params, opt_state=None, data_state=None,
                   extra=None) -> Optional[str]:
        if step % self.interval != 0:
            return None
        return self.save(step, params, opt_state, data_state, extra)

    def save(self, step: int, params, opt_state=None, data_state=None,
             extra=None) -> str:
        """Unconditional (interval-ignoring) save — the resilient loop uses
        this for the forced final checkpoint and post-degradation saves."""
        return save_checkpoint(self.directory, step, params, opt_state,
                               data_state, extra, keep=self.keep)

    def read_manifest(self, step: int) -> dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def restore_latest(self, params_template=None, opt_template=None, *,
                       template_fn=None, **kw):
        """Restore the newest valid checkpoint, falling back over corrupt
        ones (quarantining each). ``template_fn(extra) -> (params_template,
        opt_template)`` lets the caller build templates per candidate from
        its recorded manifest ``extra`` (the Trainer reconstitutes the
        degraded TrainSpec this way); otherwise the given templates apply
        to every candidate. ``kw`` goes to :func:`load_checkpoint`
        (``device``, ``verify``)."""
        steps = sorted(_list_steps(self.directory), reverse=True) \
            if os.path.isdir(self.directory) else []
        if not steps:
            return None
        for step in steps:
            try:
                if template_fn is not None:
                    manifest = self.read_manifest(step)
                    pt, ot = template_fn(manifest.get("extra", {}))
                else:
                    pt, ot = params_template, opt_template
                params, opt, data_state, extra = load_checkpoint(
                    self.directory, step, pt, ot, **kw)
                return {"step": step, "params": params, "opt_state": opt,
                        "data_state": data_state, "extra": extra}
            except (IOError, OSError, KeyError, ValueError,
                    json.JSONDecodeError) as e:
                quarantine_checkpoint(self.directory, step)
                self.quarantined.append((step, str(e)))
                log.warning(
                    "checkpoint step %d failed verification (%s); "
                    "quarantined, falling back to next-older", step, e)
        raise IOError(
            f"no restorable checkpoint in {self.directory}: all "
            f"{len(steps)} candidates failed verification and were "
            f"quarantined ({[s for s, _ in self.quarantined]})")
