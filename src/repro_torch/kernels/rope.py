"""RoPE by tables (``repro.kernels.rope``): the [N, D/2] f32 cos/sin tables
that the flash-attention kernels take when the rotation is fused into them
(``ExecutionPolicy.fuse_rope``), the plain rotation by those tables, and
the standalone rotation kernel ``csrc/rope.cu`` with its wrapper and its
autograd Function.

:func:`apply_rope_tables` rotates in f32 and casts back to x's dtype;
``models/layers.rope`` rotates with it, the dispatch applies it where the
flash path is not taken, and the flash kernels' plain versions rotate with
it.

:func:`rope_fwd` replaces the TPU kernel ``rope_fwd`` (``_rope_kernel``):
x [B, N, H, D] (the ``models/layers.rope`` layout) rotated by [N, D/2]
tables, bit for bit :func:`apply_rope_tables`. :func:`rope_apply` is the
reference's differentiable ``rope_apply``: its backward is the same kernel
at −θ (``sin`` negated), and it saves nothing but the tables, which get no
gradient. As in the reference, no path of the model runs it: the training
path fuses RoPE into the flash kernels or rotates with the plain tables.
What bounds the kernel on the H100 is bytes (x read once, written once);
a block rotates one position's heads, a thread 16 bytes of each half with
its cos and sin held in registers across the heads (the source's header
has the details).

The wrapper launches the kernel for CUDA tensors and raises on what it
does not take; a tensor on the CPU gets the plain version.
``rope_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = _build.C_PTR, _build.C_INT
_ARGS = [_I] + [_P] * 4 + [_I] * 4 + [_P]


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


def rope_fwd_ref(x, cos, sin):
    """Plain version of :func:`rope_fwd`: x [B, N, H, D], tables [N, D/2]
    broadcast over the heads."""
    return apply_rope_tables(x, cos[:, None, :], sin[:, None, :])


def rope_fwd(x, cos, sin):
    """x [B, N, H, D] (f32 or bf16, D even), cos / sin f32 [N, D/2] ->
    x rotated, in x's dtype."""
    if not x.is_cuda:
        return rope_fwd_ref(x, cos, sin)
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope_fwd kernel takes f32 or bf16, not {x.dtype}")
    if x.ndim != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope_fwd: expected x [B, N, H, D] with D even, "
                         f"got {tuple(x.shape)}")
    B, N, H, D = x.shape
    for name, t in (("x", x), ("cos", cos), ("sin", sin)):
        if t.device != x.device:
            raise ValueError(f"rope_fwd: {name} is on {t.device}, x is on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rope_fwd: {name} must be contiguous")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (N, D // 2):
            raise ValueError(f"rope_fwd: {name} must be f32 [{N}, {D // 2}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    y = torch.empty_like(x)
    fn = _build.function("rope", "rope_fwd", _ARGS)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), y.data_ptr(), B, N, H, D,
                torch.cuda.current_stream().cuda_stream)
    _build.check("rope", rc, "rope_fwd launch")
    rope_fwd.launches += 1
    return y


rope_fwd.launches = 0


class _RoPE(torch.autograd.Function):
    """The rotation forward, the same kernel at −θ backward (Rθᵀ = R₋θ);
    saves only the tables, which are constants."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_fwd(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope_fwd(g.contiguous(), cos, -sin), None, None


def rope_apply(x, cos, sin):
    """Differentiable RoPE of x [B, N, H, D] by [N, D/2] f32 tables (the
    reference's ``rope_apply``): gradients flow to x only."""
    return _RoPE.apply(x, cos, sin)
