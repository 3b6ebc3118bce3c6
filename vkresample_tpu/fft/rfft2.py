"""R2C/C2R 2D FFT built on the mixed-radix MXU engine, plus the
phase-decomposed zero-padding-aware inverse.

Forward (real image -> half spectrum), the re-design of VkFFT's R2C
path: the reference packs TWO real rows as re/im of one complex row, FFTs
once, and Hermitian-splits (vkFFT.h:1945-2058 read, 4274-4377 write,
split math 4319-4329).  We do the same row-pair pack — it halves the
x-pass work — then a plain complex y-FFT on the half spectrum.

Inverse: the reference never touches the zero band — its zero-pad guards
skip zeroed bins at read and elide all-zero sequences entirely
(vkFFT.h:1277-1470, 1536-1576; flag distribution 7222-7259).  The
equivalent here for an integer upscale factor u is *phase decomposition*:
with N = u*n and only n source bins nonzero,

    y[u*t + r] = (1/u) * ifft_n( X ⊙ w_r )[t],   w_r[k] = e^{2πi σ(k) r/N}

so the inverse becomes u (y-axis) x u (x-axis) small transforms at the
*source* size — zero bins are never computed, never materialized, and the
big spectrum never exists in memory.  σ(k) maps stored bins to their true
(signed) big-spectrum frequency, exactly encoding the spectrum relocation
of the shift pass (VkResample.cpp:516-545) and the zero-band placement
(VkResample.cpp:1491-1502).

Normalization: the u^2 renormalization the reference applies inside CAS
(VkResample.cpp:1615) cancels against the phase transforms being at source
size, so these functions feed CAS *directly* — one multiply saved per pixel.

Semantics note (validated in tests against np.fft.irfft2): the C2R x-pass
extends each row's half spectrum per-row (conj mirror) and drops the
imaginary part of the DC and Nyquist columns — we zero Im(DC) explicitly
before row-pair packing so paired rows cannot contaminate each other.
"""
from __future__ import annotations

from functools import lru_cache
import jax.numpy as jnp
import numpy as np

from .complexops import CPair
from .mixed_radix import fft

# ---------------------------------------------------------------------------
# trace-time twiddle constants
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _phase_twiddle_y(h: int, u: int, r: int, dtype_name: str):
    """ty[j] = exp(+2πi σ(j) r / (u*h)), σ(j) = j for j < h/2 else j - h.
    The y-negative half (rows [h/2, h), incl. the y-Nyquist row) relocates
    to the far edge (VkResample.cpp:521-525)."""
    j = np.arange(h)
    sigma = np.where(j < h // 2, j, j - h)
    ang = 2.0 * np.pi * sigma * r / (u * h)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


@lru_cache(maxsize=None)
def _phase_twiddle_x_r2c(w: int, u: int, r: int, k_cols: int, dtype_name: str):
    """tx[k] = exp(+2πi k r / (u*w)) over kept half-spectrum cols [0, k_cols)."""
    k = np.arange(k_cols)
    ang = 2.0 * np.pi * k * r / (u * w)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


@lru_cache(maxsize=None)
def _phase_twiddle_x_c2c(w: int, u: int, r: int, dtype_name: str):
    """tx[k] = exp(+2πi σc(k) r/(u*w)), σc(k) = k for k < w/2 else k - w —
    the c2c x relocation puts bins [w/2, w) at the far edge
    (VkResample.cpp:527-545)."""
    k = np.arange(w)
    sigma = np.where(k < w // 2, k, k - w)
    ang = 2.0 * np.pi * sigma * r / (u * w)
    return np.cos(ang).astype(dtype_name), np.sin(ang).astype(dtype_name)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def rfft2_packed(
    x: jnp.ndarray, max_factor: int = 128, k_cols: int = None
) -> CPair:
    """(..., h, w) real -> (..., h, k_cols) complex half spectrum
    (k_cols defaults to the full w//2+1).

    Row-pair packing (h must be even): z[j] = row[2j] + i*row[2j+1], one
    w-FFT per pair, Hermitian split, then a full complex y-FFT.  Passing
    k_cols = w//2 (a zero-band consumer that drops the Nyquist column)
    trims BEFORE the y transform — and keeps the lane dim a 128 multiple
    instead of the pathological w//2+1.
    """
    h, w = x.shape[-2], x.shape[-1]
    assert h % 2 == 0, "row-pair packed forward requires even height"
    zr = x[..., 0::2, :]
    zi = x[..., 1::2, :]
    Zr, Zi = fft((zr, zi), axis=-1, max_factor=max_factor)

    # Zrev[k] = Z[(w-k) % w]
    Zr_rev = jnp.concatenate([Zr[..., :1], jnp.flip(Zr[..., 1:], -1)], -1)
    Zi_rev = jnp.concatenate([Zi[..., :1], jnp.flip(Zi[..., 1:], -1)], -1)
    kk = w // 2 + 1 if k_cols is None else k_cols
    Zr_, Zi_ = Zr[..., :kk], Zi[..., :kk]
    Zr_rev, Zi_rev = Zr_rev[..., :kk], Zi_rev[..., :kk]

    # even rows: (Z + conj(Zrev))/2 ; odd rows: (Z - conj(Zrev))/(2i)
    er = 0.5 * (Zr_ + Zr_rev)
    ei = 0.5 * (Zi_ - Zi_rev)
    dr = 0.5 * (Zi_ + Zi_rev)  # Re((Z - conj Zrev)/(2i)) = (Zi + Zrev_i)/2
    di = 0.5 * (Zr_rev - Zr_)  # Im(...) = (Zrev_r - Zr)/2

    # interleave rows back: (..., h/2, 2, kk) -> (..., h, kk)
    Fr = jnp.stack([er, dr], axis=-2).reshape(x.shape[:-2] + (h, kk))
    Fi = jnp.stack([ei, di], axis=-2).reshape(x.shape[:-2] + (h, kk))

    return fft((Fr, Fi), axis=-2, max_factor=max_factor)


def fft2_c2c(x: CPair, inverse: bool = False, max_factor: int = 128) -> CPair:
    """Full complex 2D FFT over the last two axes (x-axis first, then y,
    matching the reference's axis order)."""
    X = fft(x, axis=-1, inverse=inverse, normalize=inverse, max_factor=max_factor)
    return fft(X, axis=-2, inverse=inverse, normalize=inverse, max_factor=max_factor)


# ---------------------------------------------------------------------------
# inverse: phase-decomposed, zero-band-aware
# ---------------------------------------------------------------------------


def _mul_row_twiddle(x: CPair, t, axis: int) -> CPair:
    """Multiply by a 1-D complex twiddle broadcast along `axis` (-1 or -2)."""
    tr, ti = (jnp.asarray(t[0]), jnp.asarray(t[1]))
    if axis == -2:
        tr, ti = tr[:, None], ti[:, None]
    xr, xi = x
    return xr * tr - xi * ti, xr * ti + xi * tr


def _c2r_rows_packed(P: CPair, w: int, keep_nyquist: bool, max_factor: int):
    """Per-row C2R: (..., h, K) half-spectra -> (..., h, w) real rows,
    using output-row-pair packing (h even).

    K = w//2 (+1 when keep_nyquist).  Semantics match np.fft.irfft: per-row
    conj-mirror extension, Im(DC) and Im(Nyquist) ignored.
    """
    Pr, Pi = P
    h = Pr.shape[-2]
    assert h % 2 == 0
    half = w // 2
    # drop Im(DC) so packed row pairs can't contaminate each other
    Pi = Pi.at[..., 0].set(0.0)
    nyq_r = (
        Pr[..., half : half + 1]
        if keep_nyquist
        else jnp.zeros(Pr.shape[:-1] + (1,), Pr.dtype)
    )
    body_r, body_i = Pr[..., :half], Pi[..., :half]
    # Ext[k] = P[k] (k<w/2) | Re(P[w/2]) | conj(P[w-k]) (k>w/2)
    Er = jnp.concatenate([body_r, nyq_r, jnp.flip(body_r[..., 1:], -1)], -1)
    Ei = jnp.concatenate(
        [body_i, jnp.zeros_like(nyq_r), -jnp.flip(body_i[..., 1:], -1)], -1
    )
    # pack output-row pairs: z = Ext(row 2j) + i*Ext(row 2j+1)
    zr = Er[..., 0::2, :] - Ei[..., 1::2, :]
    zi = Ei[..., 0::2, :] + Er[..., 1::2, :]
    yr, yi = fft((zr, zi), axis=-1, inverse=True, normalize=True, max_factor=max_factor)
    out = jnp.stack([yr, yi], axis=-2)  # (..., h/2, 2, w)
    return out.reshape(out.shape[:-3] + (h, w))


def irfft2_phase_planes(
    F: CPair, h: int, w: int, u: int, keep_nyquist: bool, max_factor: int = 128
):
    """Zero-band-aware inverse, PLANES form: (..., h, w//2+1) half spectrum
    -> u x u list of (..., h, w) real phase planes with
    out[u*ty+ry, u*tx+rx] = planes[ry][rx][ty, tx], pre-scaled by u^2.

    The phase decomposition IS the parity decomposition: for u=2 these are
    exactly the quad-parity pre-CAS planes the parity CAS consumes
    (ops/cas.py cas_parity_planes) — so at sizes beyond the dense
    banks the pipeline never materializes the woven image either.
    """
    Fr, Fi = F
    dt = Fr.dtype.name
    kx = w // 2 + (1 if keep_nyquist else 0)
    Fr, Fi = Fr[..., :kx], Fi[..., :kx]

    rows = []
    for ry in range(u):
        B = fft(
            _mul_row_twiddle((Fr, Fi), _phase_twiddle_y(h, u, ry, dt), axis=-2),
            axis=-2,
            inverse=True,
            normalize=True,
            max_factor=max_factor,
        )
        cols = []
        for rx in range(u):
            P = _mul_row_twiddle(
                B, _phase_twiddle_x_r2c(w, u, rx, kx, dt), axis=-1
            )
            cols.append(_c2r_rows_packed(P, w, keep_nyquist, max_factor))
        rows.append(cols)
    return rows


def irfft2_phases(
    F: CPair, h: int, w: int, u: int, keep_nyquist: bool, max_factor: int = 128
) -> jnp.ndarray:
    """Zero-band-aware inverse: (..., h, w//2+1) half spectrum -> the
    (..., u*h, u*w) real image *pre-scaled by u^2* (i.e. already in CAS
    units — the caller must NOT multiply by upscale^2 again).

    u=1 degenerates to a plain irfft2 (keep_nyquist=True then).
    """
    rows = irfft2_phase_planes(F, h, w, u, keep_nyquist, max_factor)

    # interleave phases via strided scatters: out[u*ty+ry, u*tx+rx] =
    # rows[ry][rx][ty, tx].  (A stack/moveaxis/reshape formulation creates
    # intermediates with minor dims of u, which tiled device layouts can
    # pad to 128 elements — a 128/u x memory blowup at scale.)
    batch = rows[0][0].shape[:-2]
    out = jnp.zeros(batch + (u * h, u * w), rows[0][0].dtype)
    for ry in range(u):
        for rx in range(u):
            out = out.at[..., ry::u, rx::u].set(rows[ry][rx])
    return out


def irfft2_big(F: CPair, H: int, W: int, max_factor: int = 128) -> jnp.ndarray:
    """Plain (non-phase) C2R inverse at the big size: (..., H, W//2+1) half
    spectrum -> (..., H, W) real, normalized 1/(H*W).

    Used for fractional upscale factors where phase decomposition doesn't
    apply: the big spectrum is materialized (XLA-tier semantics) but the
    transforms still run on the MXU.  Requires even H (output-row pairing).
    """
    B = fft(F, axis=-2, inverse=True, normalize=True, max_factor=max_factor)
    return _c2r_rows_packed(
        (B[0], B[1]), W, keep_nyquist=True, max_factor=max_factor
    )


def ifft2_big_c2c(F: CPair, max_factor: int = 128) -> CPair:
    """Plain complex 2D inverse (y then x), normalized — c2c fractional path."""
    B = fft(F, axis=-2, inverse=True, normalize=True, max_factor=max_factor)
    return fft(B, axis=-1, inverse=True, normalize=True, max_factor=max_factor)


def ifft2_phases_c2c(
    F: CPair, h: int, w: int, u: int, max_factor: int = 128
) -> CPair:
    """c2c variant: (..., h, w) full spectrum -> (..., u*h, u*w) complex,
    pre-scaled by u^2.  The c2c x relocation keeps bins [w/2, w) on the
    negative side (σc), matching VkResample.cpp:527-545."""
    dt = F[0].dtype.name
    rows = []
    for ry in range(u):
        B = fft(
            _mul_row_twiddle(F, _phase_twiddle_y(h, u, ry, dt), axis=-2),
            axis=-2,
            inverse=True,
            normalize=True,
            max_factor=max_factor,
        )
        cols = []
        for rx in range(u):
            P = _mul_row_twiddle(B, _phase_twiddle_x_c2c(w, u, rx, dt), axis=-1)
            cols.append(
                fft(P, axis=-1, inverse=True, normalize=True, max_factor=max_factor)
            )
        rows.append(cols)
    outs = []
    for comp in (0, 1):
        batch = rows[0][0][comp].shape[:-2]
        out = jnp.zeros(batch + (u * h, u * w), rows[0][0][comp].dtype)
        for ry in range(u):
            for rx in range(u):
                out = out.at[..., ry::u, rx::u].set(rows[ry][rx][comp])
        outs.append(out)
    return outs[0], outs[1]
