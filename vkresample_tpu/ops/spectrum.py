"""Spectrum relocation ("shift") ops.

Functional reformulation of the reference's in-place shift shader
(/root/reference/VkResample.cpp:476-548).  The reference relocates
negative-frequency bins inside one big strided buffer because its forward
FFT already wrote the small spectrum there; under XLA we instead *assemble*
the big spectrum functionally (gather-free: two static-slice writes), which
XLA fuses with the surrounding FFT stages.

The matmul tier never materializes the big spectrum at all — see
fft/rfft2.py for the phase-decomposed inverse that consumes the small
spectrum directly (and fft/dense.py for the bank formulation).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.plan import UpscalePlan


def assemble_big_spectrum(F: jnp.ndarray, plan: UpscalePlan) -> jnp.ndarray:
    """Relocate small spectrum F into the zero-padded big spectrum.

    F: (..., h, w//2+1) complex (r2c) or (..., h, w) complex (c2c).
    Returns (..., H, W//2+1) or (..., H, W).

    Geometry (even sizes): rows [h/2, h) -> [H-h/2, H) — the y-negative
    half moves to the far edge (shift shader r2c branch,
    VkResample.cpp:521-525; c2c quadrant moves 527-545).  Bins inside the
    inverse's frequency zero band [left, right) are dropped
    (VkResample.cpp:1491-1502); for r2c this kills the source Nyquist
    column w/2.
    """
    H, W = plan.H, plan.W
    klo_y, khi_y = plan.kept_lo_y, plan.kept_hi_y
    batch = F.shape[:-2]
    if plan.r2c:
        G = jnp.zeros(batch + (H, W // 2 + 1), dtype=F.dtype)
        kx = plan.kept_lo_x
        kxh = plan.kept_hi_x  # identity-position cols above the band (u=1)
        xr = plan.x_right
        G = G.at[..., :klo_y, :kx].set(F[..., :klo_y, :kx])
        if kxh:
            G = G.at[..., :klo_y, xr : xr + kxh].set(F[..., :klo_y, xr : xr + kxh])
        if khi_y:
            G = G.at[..., H - khi_y :, :kx].set(F[..., plan.h - khi_y :, :kx])
            if kxh:
                G = G.at[..., H - khi_y :, xr : xr + kxh].set(
                    F[..., plan.h - khi_y :, xr : xr + kxh]
                )
    else:
        G = jnp.zeros(batch + (H, W), dtype=F.dtype)
        kxl, kxh = plan.kept_lo_x, plan.kept_hi_x
        G = G.at[..., :klo_y, :kxl].set(F[..., :klo_y, :kxl])
        if kxh:
            G = G.at[..., :klo_y, W - kxh :].set(F[..., :klo_y, plan.w - kxh :])
        if khi_y:
            G = G.at[..., H - khi_y :, :kxl].set(F[..., plan.h - khi_y :, :kxl])
            if kxh:
                G = G.at[..., H - khi_y :, W - kxh :].set(
                    F[..., plan.h - khi_y :, plan.w - kxh :]
                )
    return G
