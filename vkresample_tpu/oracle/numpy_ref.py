"""Pure NumPy oracle of the full upscale pipeline.

This is the correctness ground truth for every other tier (XLA reference
tier, MXU matmul-FFT tier, Pallas kernels).  It implements exactly the math
of the reference GPU pipeline:

  1. uint8 -> float, /255 per channel             (VkResample.cpp:1644)
  2. forward 2D FFT at source size, unnormalized  (VkFFT forward)
  3. spectrum relocation into the zero-padded big spectrum
     (shift shader, VkResample.cpp:516-545) with the inverse pass's
     frequency zero band [left, right) deciding which bins survive
     (VkResample.cpp:1491-1502)
  4. inverse 2D FFT at target size, normalized by 1/(H*W)
     (VkFFT normalize=1 divides by the stage radix at every inverse stage,
     vkFFT.h:2922-2924, 5739 -> total 1/N per axis)
  5. FidelityFX-CAS sharpen with inputs pre-scaled by upscale^2
     (the inverse-renormalization factor, VkResample.cpp:1615; CAS math
     VkResample.cpp:887-923)
  6. x255, truncate to uint8                      (VkResample.cpp:1715)

Two spectrum modes, as in the reference:
  r2c=True : half-spectrum path.  The x zero band [w//2, W//2) drops the
             source Nyquist column entirely (VkResample.cpp:1492-1493).
  r2c=False: full complex path.  x bins [w//2, w) relocate to the far edge
             [W - w//2, W) (VkResample.cpp:527-545) and CAS consumes the
             complex *magnitude* (GLSL length(vec2), VkResample.cpp:904).
"""
from __future__ import annotations

import numpy as np

from ..core.plan import UpscalePlan


def assemble_big_spectrum(F: np.ndarray, plan: UpscalePlan) -> np.ndarray:
    """Relocate the small spectrum F into the zero-padded big spectrum.

    F: (h, w//2+1) complex for r2c, (h, w) complex for c2c.
    Returns (H, W//2+1) or (H, W) complex.
    """
    H, W = plan.H, plan.W
    klo_y, khi_y = plan.kept_lo_y, plan.kept_hi_y
    if plan.r2c:
        G = np.zeros((H, W // 2 + 1), dtype=F.dtype)
        kx = plan.kept_lo_x
        kxh = plan.kept_hi_x  # identity-position cols above the band (u=1)
        G[:klo_y, :kx] = F[:klo_y, :kx]
        if kxh:
            G[:klo_y, plan.x_right : plan.x_right + kxh] = F[
                :klo_y, plan.x_right : plan.x_right + kxh
            ]
        if khi_y:
            G[H - khi_y :, :kx] = F[plan.h - khi_y :, :kx]
            if kxh:
                G[H - khi_y :, plan.x_right : plan.x_right + kxh] = F[
                    plan.h - khi_y :, plan.x_right : plan.x_right + kxh
                ]
    else:
        G = np.zeros((H, W), dtype=F.dtype)
        kxl, kxh = plan.kept_lo_x, plan.kept_hi_x
        G[:klo_y, :kxl] = F[:klo_y, :kxl]
        G[:klo_y, W - kxh :] = F[:klo_y, plan.w - kxh :]
        if khi_y:
            G[H - khi_y :, :kxl] = F[plan.h - khi_y :, :kxl]
            G[H - khi_y :, W - kxh :] = F[plan.h - khi_y :, plan.w - kxh :]
    return G


def cas_sharpen(v: np.ndarray, sharpen: float) -> np.ndarray:
    """FidelityFX-CAS sharpen, exact reference math (VkResample.cpp:887-923).

    v: (H, W) real (r2c path) or complex (c2c path), already
       pre-scaled by upscale^2.
    Returns the sharpened image in [0, ~1+] (not yet clamped/quantized).
    """
    ln = np.abs(v)  # length(): complex magnitude or real abs alike
    ln = np.clip(ln, 0.0, 1.0)

    p = np.pad(ln, 1, mode="edge")  # clamp-to-edge neighbor indexing
    c = p[1:-1, 1:-1]
    n = p[:-2, 1:-1]
    s = p[2:, 1:-1]
    wv = p[1:-1, :-2]
    e = p[1:-1, 2:]
    nw = p[:-2, :-2]
    ne = p[:-2, 2:]
    sw = p[2:, :-2]
    se = p[2:, 2:]

    # two-level min/max: cross first, then corners (VkResample.cpp:908-916)
    min_cross = np.minimum(n, np.minimum(wv, np.minimum(c, np.minimum(e, s))))
    min_all = np.minimum(min_cross, np.minimum(nw, np.minimum(ne, np.minimum(sw, se))))
    max_cross = np.maximum(n, np.maximum(wv, np.maximum(c, np.maximum(e, s))))
    max_all = np.maximum(max_cross, np.maximum(nw, np.maximum(ne, np.maximum(sw, se))))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)

    with np.errstate(divide="ignore", invalid="ignore"):
        lo = minlen / (1.0 - minlen)
        hi = (1.0 - maxlen) / maxlen
        scale = np.where(lo < hi, lo, hi)
        scale = np.where(np.isnan(scale), 0.0, scale)
        scale = -sharpen * np.sqrt(np.maximum(scale, 0.0))

    out = (c + scale * (n + wv + e + s)) / (1.0 + 4.0 * scale)
    return out


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """255*x truncated to uint8.  The reference C-casts without clamping
    (UB for out-of-range, VkResample.cpp:1715); we clamp then truncate."""
    return np.clip(x * 255.0, 0.0, 255.0).astype(np.uint8)


def upscale_oracle(
    img: np.ndarray, plan: UpscalePlan, dtype=np.float64
) -> np.ndarray:
    """Full-pipeline oracle.  img: (h, w, C) uint8.  Returns (H, W, C) uint8."""
    h, w, C = img.shape
    assert (h, w) == (plan.h, plan.w), (img.shape, plan)
    u2 = float(np.float32(plan.upscale)) ** 2
    out = np.empty((plan.H, plan.W, C), np.uint8)
    for ch in range(C):
        f = img[:, :, ch].astype(dtype) / 255.0
        if plan.r2c:
            F = np.fft.rfft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.irfft2(G, s=(plan.H, plan.W))
            sharp = cas_sharpen(u2 * y, plan.sharpen)
        else:
            F = np.fft.fft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.ifft2(G)
            sharp = cas_sharpen(u2 * y, plan.sharpen)
        out[:, :, ch] = quantize_u8(sharp)
    return out


def upscale_oracle_float(
    img: np.ndarray, plan: UpscalePlan, dtype=np.float64
) -> np.ndarray:
    """Like upscale_oracle but returns the pre-quantization float image
    (H, W, C) — useful for tolerance analysis in tests."""
    h, w, C = img.shape
    u2 = float(np.float32(plan.upscale)) ** 2
    outs = []
    for ch in range(C):
        f = img[:, :, ch].astype(dtype) / 255.0
        if plan.r2c:
            F = np.fft.rfft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.irfft2(G, s=(plan.H, plan.W))
            outs.append(cas_sharpen(u2 * y, plan.sharpen))
        else:
            F = np.fft.fft2(f)
            G = assemble_big_spectrum(F, plan)
            y = np.fft.ifft2(G)
            outs.append(cas_sharpen(u2 * y, plan.sharpen))
    return np.stack(outs, axis=-1)
