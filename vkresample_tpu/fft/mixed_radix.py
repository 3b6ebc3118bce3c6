"""Mixed-radix MXU FFT: Cooley-Tukey decomposition into DFT-matrix
contractions.

This is the matmul re-design of the VkFFT engine core (scheduler
vkFFT.h:4707-5189 + codegen 211-4642).  Where VkFFT generates radix-2/3/4/
5/7/8 register butterflies with shared-memory shuffles per workgroup, this
decomposition groups prime factors into *composite* radixes up to 128
(core/smooth.plan_factors) so every butterfly stage becomes one batched
matmul against a constant DFT matrix (contraction dim <= 128).  Twiddle
tables are trace-time numpy constants (the analog of VkFFT's optional LUT,
vkFFT.h:6157-6308, but baked into the program), and XLA plays glslang's role compiling the specialized graph.

Decimation in time, recursive over the factor list.  For N = f*M with input
index n = f*m + r and output index k = q + M*s:

    A[r, q]     = FFT_M(x[f*m + r], over m)          (recurse)
    B[r, q]     = W_N^{sign*r*q} * A[r, q]           (twiddle, VPU)
    X[q + M*s]  = sum_r DFT_f[s, r] * B[r, q]        (matmul, MXU)

All data is (re, im) pairs; complex matmuls use 3-real-matmul Karatsuba
with precomputed (Dr+Di) constants.
"""
from __future__ import annotations

from functools import lru_cache
import jax
import jax.numpy as jnp
import numpy as np

from ..core.smooth import plan_factors
from .complexops import CPair

_HIGH = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _dft_mats(n: int, sign: int, dtype_name: str, scale: float):
    """Constant DFT matrix D[s, r] = scale * exp(sign*2j*pi*s*r/n) as
    (Dr, Di, Dr+Di) numpy arrays (the sum feeds Karatsuba)."""
    s = np.arange(n)[:, None] * np.arange(n)[None, :]
    ang = sign * 2.0 * np.pi * s / n
    dr = (np.cos(ang) * scale).astype(dtype_name)
    di = (np.sin(ang) * scale).astype(dtype_name)
    return dr, di, (dr + di).astype(dtype_name)


@lru_cache(maxsize=None)
def _twiddle(f: int, m: int, sign: int, dtype_name: str):
    """Inter-stage twiddle T[r, q] = exp(sign*2j*pi*r*q/(f*m))."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(f), np.arange(m)) / (f * m)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


def _cmatmul(D, x: CPair, spec: str) -> CPair:
    """Complex constant-matrix contraction via 3 real matmuls (Karatsuba):
    (Dr + iDi)(xr + ixi): t1=Dr@xr, t2=Di@xi, t3=(Dr+Di)@(xr+xi)."""
    dr, di, drpdi = D
    xr, xi = x
    dr = jnp.asarray(dr)
    di = jnp.asarray(di)
    drpdi = jnp.asarray(drpdi)
    t1 = jnp.einsum(spec, dr, xr, precision=_HIGH)
    t2 = jnp.einsum(spec, di, xi, precision=_HIGH)
    t3 = jnp.einsum(spec, drpdi, xr + xi, precision=_HIGH)
    return t1 - t2, t3 - t1 - t2


def _fft_axis(x: CPair, factors, sign: int, axis: int, scale: float) -> CPair:
    """Recursive mixed-radix FFT along `axis` (-1 or -2).  `scale` is folded
    into the leaf DFT constants (used for 1/N inverse normalization)."""
    xr, xi = x
    n = xr.shape[axis]
    dt = xr.dtype.name
    if len(factors) == 1:
        D = _dft_mats(n, sign, dt, scale)
        spec = "sr,...r->...s" if axis == -1 else "sr,...rx->...sx"
        return _cmatmul(D, x, spec)

    f, rest = factors[0], factors[1:]
    m = n // f
    if axis == -1:
        shp = xr.shape[:-1] + (m, f)
        xr = jnp.swapaxes(xr.reshape(shp), -1, -2)  # (..., f, m): [r, q-axis]
        xi = jnp.swapaxes(xi.reshape(shp), -1, -2)
        ar, ai = _fft_axis((xr, xi), rest, sign, -1, scale)
        tr, ti = _twiddle(f, m, sign, dt)
        tr = jnp.asarray(tr)
        ti = jnp.asarray(ti)
        br = ar * tr - ai * ti
        bi = ar * ti + ai * tr
        D = _dft_mats(f, sign, dt, 1.0)
        yr, yi = _cmatmul(D, (br, bi), "sr,...rq->...sq")
        out_shape = yr.shape[:-2] + (n,)
        return yr.reshape(out_shape), yi.reshape(out_shape)

    if axis == -2:
        pre, xlen = xr.shape[:-2], xr.shape[-1]
        shp = pre + (m, f, xlen)
        xr = jnp.swapaxes(xr.reshape(shp), -2, -3)  # (..., f, m, X)
        xi = jnp.swapaxes(xi.reshape(shp), -2, -3)
        ar, ai = _fft_axis((xr, xi), rest, sign, -2, scale)
        tr, ti = _twiddle(f, m, sign, dt)
        tr = jnp.asarray(tr)[..., None]
        ti = jnp.asarray(ti)[..., None]
        br = ar * tr - ai * ti
        bi = ar * ti + ai * tr
        D = _dft_mats(f, sign, dt, 1.0)
        yr, yi = _cmatmul(D, (br, bi), "sr,...rqx->...sqx")
        out_shape = pre + (n, xlen)
        return yr.reshape(out_shape), yi.reshape(out_shape)

    raise ValueError(f"axis must be -1 or -2, got {axis}")


def fft(
    x: CPair,
    axis: int = -1,
    inverse: bool = False,
    normalize: bool = True,
    max_factor: int = 128,
) -> CPair:
    """Complex mixed-radix FFT of a (re, im) pair along axis -1 or -2.

    Forward is unnormalized; inverse divides by N when normalize=True —
    matching VkFFT's convention (normalize=1 divides by the stage radix at
    every inverse stage, vkFFT.h:2922-2924).
    """
    n = x[0].shape[axis]
    if n == 1:
        return x
    factors = plan_factors(n, max_factor)
    sign = 1 if inverse else -1
    scale = (1.0 / n) if (inverse and normalize) else 1.0
    return _fft_axis(x, factors, sign, axis, scale)
