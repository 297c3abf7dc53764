"""Checkpoints of a run on a mesh of ranks (the counterpart of the
reference's checkpoints of a sharded program): :class:`MeshCheckpointer`.
The files are those of ``checkpoint/checkpointer.py``, whole, whatever the
mesh."""
from __future__ import annotations

import os

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, load_checkpoint
from repro_torch.runtime import elastic


class MeshCheckpointer(Checkpointer):
    """A run's checkpointer on a mesh of ranks. Every save first gathers
    each sharded leaf whole (``gather(params, opt_state)``, collective over
    the model axes; the checkpoint is the single process's tree, so one
    written at a model axis of 2 restores at 1 and the reverse). Rank 0
    (the mesh's first) alone changes the directory: it writes each
    checkpoint, and on a restore it alone picks the step, quarantining the
    corrupt ones. Every save and restore ends with rank 0's outcome
    broadcast over the mesh (``group``): the other ranks load the step it
    picked read-only, and a save or restore that failed on rank 0 raises
    on every rank, so no rank waits in a collective for one that left. A
    restore returns the whole tree; the caller places it on the live
    mesh."""

    def __init__(self, directory, interval, mesh, group=None, gather=None):
        super().__init__(directory, interval=interval)
        self.mesh, self.group = mesh, group
        self.first = mesh.rank_list[0] == elastic.rank()
        self.gather = gather

    def _agree(self, outcome):
        """Rank 0's ``outcome``, on every rank of the mesh."""
        box = [outcome]
        if self.mesh.size > 1:
            torch.distributed.broadcast_object_list(
                box, src=self.mesh.rank_list[0], group=self.group)
        return box[0]

    def save(self, step, params, opt_state=None, data_state=None,
             extra=None):
        path = os.path.join(self.directory, f"step_{step:08d}")
        if self.gather is not None:
            params, opt_state = self.gather(params, opt_state)
        if self.first:
            try:
                path = super().save(step, params, opt_state, data_state,
                                    extra)
            except Exception as e:
                self._agree(f"{type(e).__name__}: {e}")
                raise
        failed = self._agree(None)
        if failed is not None:
            raise RuntimeError(f"rank 0 failed to save step {step}: "
                               f"{failed}")
        return path     # every rank: the loop's save bookkeeping agrees

    def restore_latest(self, params_template=None, opt_template=None, *,
                       template_fn=None, **kw):
        if self.first:
            seen = len(self.quarantined)
            try:
                restored = super().restore_latest(
                    params_template, opt_template, template_fn=template_fn,
                    **kw)
            except Exception as e:
                self._agree({"error": f"{type(e).__name__}: {e}",
                             "io": isinstance(e, IOError),
                             "quarantined": self.quarantined[seen:]})
                raise
            self._agree({"step": restored and restored["step"],
                         "quarantined": self.quarantined[seen:]})
            return restored
        told = self._agree(None)
        self.quarantined.extend(told["quarantined"])
        if "error" in told:
            raise (IOError if told["io"] else RuntimeError)(
                f"rank 0's restore failed: {told['error']}")
        step = told["step"]
        if step is None:
            return None
        pt, ot = params_template, opt_template
        if template_fn is not None:
            pt, ot = template_fn(self.read_manifest(step).get("extra", {}))
        params, opt, data_state, extra = load_checkpoint(
            self.directory, step, pt, ot, **kw)
        return {"step": step, "params": params, "opt_state": opt,
                "data_state": data_state, "extra": extra}
