"""Frequency-domain convolution — the VkFFT engine capability surface.

The reference engine supports a convolution step fused between forward and
inverse transforms (vkFFT.h:45-48 config, codegen 3157-3517): elementwise
spectrum multiply, multi-kernel batching (numberKernels), and 2x2/3x3
*matrix* convolution across coordinateFeatures (output feature = sum over
input features of kernel-matrix entries).  VkResample itself never calls
it, but it is part of the engine surface this framework reproduces.

Formulation: the transforms run on the IN-HOUSE mixed-radix matmul
engine (fft/ndim.py) whenever both axes factor over the engine's
radix set, mirroring how the reference fuses the convolution inside its
own engine rather than calling an external FFT; sizes the engine cannot
factor fall back to XLA's native FFT op.  The kernel spectrum is computed
once per (kernel, shape) — the analog of VkFFT uploading and transforming
the kernel at plan time (vkFFT.h:3157) — and the spectrum multiply sits
between our forward/inverse passes.  Circular convolution semantics
(FFT-native, as the reference's).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..fft.complexops import CPair
from ..fft.ndim import irfftn, rfftn

MAX_FACTOR = 128  # engine radix cap (core/smooth.py composite radixes)


def _engine_ok(*dims: int, max_factor: int = MAX_FACTOR) -> bool:
    """True when every axis factors over the mixed-radix engine's radix
    set — 7-smooth, like the reference engine (vkFFT.h:4716-4726)."""
    from ..core.smooth import is_7smooth

    return all(is_7smooth(int(n)) for n in dims)


def _pair_mul(A: CPair, B: CPair) -> CPair:
    ar, ai = A
    br, bi = B
    return ar * br - ai * bi, ar * bi + ai * br


def _resolve_engine(engine: str, h: int, w: int) -> str:
    if engine == "auto":
        # perf routing, not capability: auto prefers XLA's native FFT
        # (cuFFT on the GPU; which engine is faster there is
        # unmeasured); engine="mxu" keeps the
        # in-house path (required for non-XLA-native layouts and the
        # engine-parity surface), and non-7-smooth sizes must use xla.
        import os

        pref = os.environ.get("VKRESAMPLE_CONV_ENGINE", "xla")
        return pref if pref == "xla" or _engine_ok(h, w) else "xla"
    if engine == "mxu" and not _engine_ok(h, w):
        raise ValueError(
            f"{h}x{w} does not factor over the engine radix set (<= "
            f"{MAX_FACTOR}); use engine='xla'"
        )
    return engine


def kernel_spectrum(kernel: jnp.ndarray, engine: str = "auto"):
    """Forward-transform a convolution kernel once (plan-time analog of
    VkFFT's kernel upload+transform).  Returns an engine-tagged spectrum
    consumable by fft_convolve2d/fft_matrix_convolve2d."""
    kernel = jnp.asarray(kernel)
    h, w = kernel.shape[-2], kernel.shape[-1]
    eng = _resolve_engine(engine, h, w)
    if eng == "mxu":
        return ("mxu", rfftn(kernel, axes=(-2, -1), max_factor=MAX_FACTOR))
    return ("xla", jnp.fft.rfft2(kernel))


def _separable_factors(kernel):
    """(ky, kx) with kernel == outer(ky, kx) to fp precision (rank-1 /
    separable — Gaussian blur, box, any outer-product filter), or None.
    Host-side plan-time detection: requires a CONCRETE kernel (numpy or
    committed device array); traced kernels return None.

    Cost is one O(h·w) pivot probe (NOT an SVD — a 4096x4096
    non-separable kernel must not pay O(n^3) host work per call just to
    be told "no"): take the max-|.| element as pivot, reconstruct from
    its row/column, and accept only if the residual vanishes at the
    kernel's own storage precision."""
    try:
        k = np.asarray(kernel, np.float64)
    except Exception:
        return None
    if k.ndim != 2 or min(k.shape) < 2 or not np.all(np.isfinite(k)):
        return None
    # threshold scales with the kernel's own storage precision: a kernel
    # CONSTRUCTED as an outer product but stored in f32 carries ~eps_f32
    # of rank-2 rounding residue (measured 1.7e-8 for a f32 Gaussian);
    # anything above that is genuinely non-separable and must keep the
    # exact spectrum path.  Integer-stored kernels are exact: float64
    # eps is the right floor there (np.finfo rejects integer dtypes).
    dt = np.dtype(getattr(kernel, "dtype", np.float64))
    eps = float(np.finfo(dt).eps) if np.issubdtype(dt, np.inexact) else float(
        np.finfo(np.float64).eps
    )
    amax = float(np.abs(k).max())
    if amax == 0.0:  # the zero kernel is outer(0, 0)
        return np.zeros(k.shape[0]), np.zeros(k.shape[1])
    i, j = np.unravel_index(int(np.abs(k).argmax()), k.shape)
    ky = k[:, j]
    kx = k[i, :] / k[i, j]
    if float(np.abs(k - np.outer(ky, kx)).max()) > 32.0 * eps * amax:
        return None
    return ky, kx


# largest axis for the separable fused path: the staged banks ride as
# trace-time constants when the caller jits around a concrete kernel,
# and multi-MB HLO literal constants bloat the program text and its
# compile
_SEPARABLE_MAX = 4096


def _separable_conv(x, ky, kx):
    """FUSED separable convolution: the kernel's eigenvalues fold INTO
    the staged circulant transform banks (fft/staged.py conv_banks), so
    the spectrum multiply of the reference's in-kernel convolution step
    (vkFFT.h:3157-3517) costs ZERO extra passes here — each axis is the
    same three batched matmuls a plain transform takes, with the
    kernel baked into the middle bank.  The matmul-engine endpoint of the
    'fused convolution' capability for the separable class."""
    from ..fft.staged import conv_banks

    banks = {
        kname: jnp.asarray(v)
        for arr, pfx in ((ky, "cvy_"), (kx, "cvx_"))
        for kname, v in conv_banks(np.asarray(arr, np.float64), pfx).items()
    }
    from ..fft.staged import conv_apply_lanes, conv_apply_rows

    y = conv_apply_lanes(x, banks, "cvx_", jax.lax.Precision.HIGHEST)
    return conv_apply_rows(y, banks, "cvy_", jax.lax.Precision.HIGHEST)


def fft_convolve2d(x: jnp.ndarray, kernel, engine: str = "auto") -> jnp.ndarray:
    """Circular 2D convolution via the frequency domain.

    x:      (..., h, w) real.
    kernel: (h, w) — one kernel broadcast over leading dims, or
            (K, h, w) — K kernels (VkFFT numberKernels batching): output
            gains a leading K axis.  A pre-transformed kernel_spectrum()
            result is also accepted.
    engine: "auto" (in-house MXU engine when the sizes factor), "mxu",
            or "xla".

    Concrete SEPARABLE kernels take the fused staged path (see
    _separable_conv): no spectrum ever materializes.  Disable with
    VKRESAMPLE_CONV_SEPARABLE=0.
    """
    import os

    from ..fft.staged import split_factors

    x = jnp.asarray(x)
    h, w = x.shape[-2], x.shape[-1]
    # the fused separable path is a perf routing decision, so it applies
    # only to engine="auto": an EXPLICIT engine request is a contract
    # (the mxu-vs-xla parity surface must keep exercising the in-house
    # spectrum path, and its size errors must keep firing)
    if (
        not isinstance(kernel, tuple)
        and engine == "auto"
        and os.environ.get("VKRESAMPLE_CONV_SEPARABLE", "1") != "0"
        and getattr(kernel, "ndim", 0) == 2
        and max(h, w) <= _SEPARABLE_MAX
        and (h, w) == (kernel.shape[-2], kernel.shape[-1])
        and split_factors(h) is not None
        and split_factors(w) is not None
    ):
        sep = _separable_factors(kernel)
        if sep is not None:
            return _separable_conv(x, *sep)
    if isinstance(kernel, tuple) and kernel[0] in ("mxu", "xla"):
        eng, Kspec = kernel
    else:
        eng = _resolve_engine(engine, h, w)
        _, Kspec = kernel_spectrum(jnp.asarray(kernel, x.dtype), eng)
    if eng == "mxu":
        X = rfftn(x, axes=(-2, -1), max_factor=MAX_FACTOR)
        Kr, Ki = Kspec
        if Kr.ndim == 2:
            Y = _pair_mul(X, (Kr, Ki))
        else:  # (K, h, w2) kernel bank: output gains a leading K axis
            shape = Kr.shape[:1] + (1,) * (X[0].ndim - 2) + Kr.shape[1:]
            Y = _pair_mul(
                (X[0][None], X[1][None]),
                (Kr.reshape(shape), Ki.reshape(shape)),
            )
        return irfftn(Y, s=(h, w), axes=(-2, -1), max_factor=MAX_FACTOR)
    X = jnp.fft.rfft2(x)
    if Kspec.ndim == 2:
        return jnp.fft.irfft2(X * Kspec, s=(h, w))
    shape = Kspec.shape[:1] + (1,) * (X.ndim - 2) + Kspec.shape[1:]
    return jnp.fft.irfft2(Kspec.reshape(shape) * X[None], s=(h, w))


def fft_matrix_convolve2d(
    x: jnp.ndarray, kernel: jnp.ndarray, engine: str = "auto"
) -> jnp.ndarray:
    """Matrix convolution over coordinate features (vkFFT matrixConvolution,
    vkFFT.h:46: 2x2/3x3 supported there; any square size here).

    x:      (..., C, h, w) — C coordinate features.
    kernel: (Cout, Cin, h, w) with Cin == C.
    Returns (..., Cout, h, w): out[o] = sum_i kernel[o, i] (*) x[i].
    """
    x = jnp.asarray(x)
    kernel = jnp.asarray(kernel, x.dtype)
    C = x.shape[-3]
    if kernel.shape[1] != C:
        raise ValueError(f"kernel Cin {kernel.shape[1]} != x features {C}")
    h, w = x.shape[-2], x.shape[-1]
    eng = _resolve_engine(engine, h, w)
    if eng == "mxu":
        Xr, Xi = rfftn(x, axes=(-2, -1), max_factor=MAX_FACTOR)
        Kr, Ki = rfftn(kernel, axes=(-2, -1), max_factor=MAX_FACTOR)
        Yr = jnp.einsum("oihw,...ihw->...ohw", Kr, Xr) - jnp.einsum(
            "oihw,...ihw->...ohw", Ki, Xi
        )
        Yi = jnp.einsum("oihw,...ihw->...ohw", Kr, Xi) + jnp.einsum(
            "oihw,...ihw->...ohw", Ki, Xr
        )
        return irfftn((Yr, Yi), s=(h, w), axes=(-2, -1), max_factor=MAX_FACTOR)
    X = jnp.fft.rfft2(x)  # (..., C, h, w2)
    Kf = jnp.fft.rfft2(kernel)  # (Cout, Cin, h, w2)
    Y = jnp.einsum("oihw,...ihw->...ohw", Kf, X)
    return jnp.fft.irfft2(Y, s=(h, w))


def _smooth_up(n: int, max_factor: int = MAX_FACTOR) -> int:
    """Smallest m >= n that factors over the engine radix set."""
    m = int(n)
    while not _engine_ok(m, max_factor=max_factor):
        m += 1
    return m


def fft_convolve2d_linear(
    x: jnp.ndarray, kernel: jnp.ndarray, engine: str = "auto"
) -> jnp.ndarray:
    """LINEAR (non-circular) 2D convolution via SPATIAL zero-padding —
    the vkFFT spatial zero-pad capability (frequencyZeroPadding=0 default,
    vkFFT.h:37-39): both operands are zero-extended to a common smooth
    size >= h+hk-1 so wraparound never aliases, transformed, multiplied,
    and cropped to the 'full' convolution extent (h+hk-1, w+wk-1).

    x: (..., h, w) real; kernel: (hk, wk).  The reference elides reads of
    the zero region inside its kernels; under XLA the padded transforms
    are constant-folded/fused, and the kernel spectrum is computed once
    at trace time for concrete kernels.
    """
    x = jnp.asarray(x)
    kernel = jnp.asarray(kernel, x.dtype)
    h, w = x.shape[-2], x.shape[-1]
    hk, wk = kernel.shape[-2], kernel.shape[-1]
    H = _smooth_up(h + hk - 1)
    W = _smooth_up(w + wk - 1)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, H - h), (0, W - w)])
    kp = jnp.pad(kernel, [(0, H - hk), (0, W - wk)])
    out = fft_convolve2d(xp, kp, engine=engine)
    return out[..., : h + hk - 1, : w + wk - 1]


def gaussian_kernel(h: int, w: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """Centered periodic Gaussian kernel, unit mass — a convenience for the
    convolution surface (blur/AA filters)."""
    y = np.minimum(np.arange(h), h - np.arange(h))[:, None]
    x = np.minimum(np.arange(w), w - np.arange(w))[None, :]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(dtype)
