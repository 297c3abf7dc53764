"""RoPE by tables (``repro.kernels.rope``): the [N, D/2] f32 cos/sin tables
that the flash-attention kernels take when the rotation is fused into them
(``ExecutionPolicy.fuse_rope``), and the plain rotation by those tables.

:func:`apply_rope_tables` rotates in f32 and casts back to x's dtype;
``models/layers.rope`` rotates with it, the dispatch applies it where the
flash path is not taken, and the flash kernels' plain versions rotate with
it. The reference's standalone RoPE kernel (``rope_fwd`` / ``rope_apply``)
runs on no path of the JAX package and is not ported.
"""
from __future__ import annotations

import torch


def rope_tables(positions, theta: float, d: int):
    """(cos, sin) f32 tables [*positions.shape, d//2]: [N, d//2] for the
    1-D positions the flash kernels take."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope_tables(x, cos, sin):
    """Rotate the half-split last dim of x by tables that broadcast against
    its half (x [..., N, D] with [N, D//2] tables): f32 arithmetic, cast
    back to x's dtype. ``sin`` negated gives the inverse rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)
