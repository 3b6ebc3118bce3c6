"""Dense DFT engine: every transform axis as one constant-matrix contraction.

For the sizes this application lives at (<= 4K), the O(N^2) dense DFT is
one large matrix product per axis with ZERO inter-stage relayouts (the
mixed-radix path pays a full device-memory round-trip per stage for its
reshape/transpose), and the zero-band-aware inverse collapses into a
*rectangular* (N_out x n_kept) matrix that

  - encodes the spectrum relocation (shift pass, VkResample.cpp:516-545)
    in its frequency map sigma(j),
  - skips zeroed bins by simply not having columns for them (the analog
    of VkFFT's zero-pad guards, vkFFT.h:1277-1470 — zero bins never touched),
  - emits output rows directly in final order (no phase interleave),
  - works uniformly for integer AND fractional factors, and
  - folds the 1/N normalization and the CAS u^2 pre-scale cancellation in.

The C2R x-pass uses two REAL matmuls (cos/sin banks), which drops the
imaginary parts of the DC/Nyquist bins exactly as the reference's C2R does
(see docs/MATH.md §3).

Complex x complex contractions use 3-real-matmul Karatsuba with the
(Dr+Di) bank precomputed.  Matmul precision is a parameter, chosen per
mode in core/config.py (Precision.matmul_precision).
"""
from __future__ import annotations

from functools import lru_cache
import jax
import jax.numpy as jnp
import numpy as np

from .complexops import CPair

# ---------------------------------------------------------------------------
# constant matrix banks (numpy, cached per geometry)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _fwd_r2c_bank(w: int, K: int, dtype: str):
    """R2C forward x-pass: X[k] = sum_n x[n] e^{-2pi i k n / w}, k in [0,K).
    Returns real (w, K) cos and -sin banks (contract over n)."""
    n = np.arange(w)[:, None]
    k = np.arange(K)[None, :]
    ang = -2.0 * np.pi * n * k / w
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@lru_cache(maxsize=None)
def _fwd_c2c_bank(n: int, dtype: str):
    """Square forward DFT (n, n): D[j, t] = e^{-2pi i j t / n} (contract j)."""
    jt = np.arange(n)[:, None] * np.arange(n)[None, :]
    ang = -2.0 * np.pi * jt / n
    dr = np.cos(ang).astype(dtype)
    di = np.sin(ang).astype(dtype)
    return dr, di, (dr + di).astype(dtype)


@lru_cache(maxsize=None)
def _inv_y_bank(
    h: int, H: int, kept_lo: int, kept_hi: int, dtype: str
):
    """Zero-band inverse y matrix (h, H): DY[j, m] = (1/h) e^{+2pi i sigma(j) m / H}
    with sigma(j) = j for j < kept_lo, j - h for j >= h - kept_hi, and a
    ZERO column for dropped bins (contract over j).

    The 1/h (not 1/H) normalization folds the u_y factor of the CAS
    upscale^2 pre-scale (VkResample.cpp:1615) — see docs/MATH.md §4.
    """
    j = np.arange(h)
    sigma = np.where(j < kept_lo, j, j - h).astype(np.float64)
    keep = (j < kept_lo) | (j >= h - kept_hi)
    m = np.arange(H)[None, :]
    ang = 2.0 * np.pi * sigma[:, None] * m / H
    scale = keep.astype(np.float64)[:, None] / h
    dr = (np.cos(ang) * scale).astype(dtype)
    di = (np.sin(ang) * scale).astype(dtype)
    return dr, di, (dr + di).astype(dtype)


@lru_cache(maxsize=None)
def _inv_x_r2c_bank(
    w: int, W: int, kept_lo: int, keep_nyquist: bool, K: int, dtype: str
):
    """Zero-band C2R x matrices (K, W):
    out[n] = sum_k A[k, n] Re P[k] + B[k, n] Im P[k]
    A[k, n] = c_k cos(2pi k n / W)/w,  B[k, n] = -c_k sin(2pi k n / W)/w
    c_0 = 1, c_k = 2 for 0 < k < w/2; Nyquist col (k = w/2, present only
    when keep_nyquist) has c = 1 and B = 0 (Im dropped, per C2R semantics).
    Dropped bins (k >= kept_lo and not Nyquist-kept) are zero columns.
    """
    k = np.arange(K)[:, None].astype(np.float64)
    n = np.arange(W)[None, :]
    ang = 2.0 * np.pi * k * n / W
    c = np.full((K, 1), 2.0)
    c[0, 0] = 1.0
    keep = (np.arange(K) < kept_lo).astype(np.float64)[:, None]
    bmask = keep.copy()
    if keep_nyquist and K > w // 2:
        keep[w // 2, 0] = 1.0
        if w % 2 == 0:
            c[w // 2, 0] = 1.0  # true Nyquist: Re kept once, Im dropped
        else:
            bmask[w // 2, 0] = 1.0  # odd w: regular paired bin (c=2, Im kept)
    A = (np.cos(ang) * c * keep / w).astype(dtype)
    B = (-np.sin(ang) * c * bmask / w).astype(dtype)
    return A, B


@lru_cache(maxsize=None)
def _inv_x_c2c_bank(w: int, W: int, kept_lo: int, kept_hi: int, dtype: str):
    """Zero-band complex inverse x matrix (w, W) with sigma_c mapping
    (c2c relocation, VkResample.cpp:527-545), 1/w normalized."""
    k = np.arange(w)
    sigma = np.where(k < kept_lo, k, k - w).astype(np.float64)
    keep = (k < kept_lo) | (k >= w - kept_hi)
    n = np.arange(W)[None, :]
    ang = 2.0 * np.pi * sigma[:, None] * n / W
    scale = keep.astype(np.float64)[:, None] / w
    dr = (np.cos(ang) * scale).astype(dtype)
    di = (np.sin(ang) * scale).astype(dtype)
    return dr, di, (dr + di).astype(dtype)


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------


def _cc_contract(D, x: CPair, spec: str, precision) -> CPair:
    """(complex constant) x (complex data) via Karatsuba (3 real matmuls)."""
    dr, di, drpdi = (jnp.asarray(a) for a in D)
    xr, xi = x
    t1 = jnp.einsum(spec, dr, xr, precision=precision)
    t2 = jnp.einsum(spec, di, xi, precision=precision)
    t3 = jnp.einsum(spec, drpdi, xr + xi, precision=precision)
    return t1 - t2, t3 - t1 - t2


def fwd_r2c_x(x: jnp.ndarray, K: int, precision) -> CPair:
    """(..., h, w) real -> (..., h, K) half spectrum (x-axis forward)."""
    w = x.shape[-1]
    C, S = _fwd_r2c_bank(w, K, x.dtype.name)
    xr = jnp.einsum("...w,wk->...k", x, jnp.asarray(C), precision=precision)
    xi = jnp.einsum("...w,wk->...k", x, jnp.asarray(S), precision=precision)
    return xr, xi


def fwd_c2c_y(X: CPair, precision) -> CPair:
    """Forward complex DFT over axis -2."""
    h = X[0].shape[-2]
    D = _fwd_c2c_bank(h, X[0].dtype.name)
    return _cc_contract(D, X, "jt,...jk->...tk", precision)


def fwd_c2c_x(X: CPair, precision) -> CPair:
    """Forward complex DFT over axis -1."""
    w = X[0].shape[-1]
    D = _fwd_c2c_bank(w, X[0].dtype.name)
    return _cc_contract(D, X, "jt,...j->...t", precision)


def inv_y(F: CPair, h: int, H: int, kept_lo: int, kept_hi: int, precision) -> CPair:
    """Zero-band inverse over axis -2: (..., h, K) -> (..., H, K)."""
    D = _inv_y_bank(h, H, kept_lo, kept_hi, F[0].dtype.name)
    return _cc_contract(D, F, "jm,...jk->...mk", precision)


def inv_x_r2c(
    P: CPair, w: int, W: int, kept_lo: int, keep_nyquist: bool, precision
) -> jnp.ndarray:
    """Zero-band C2R over axis -1: (..., K) complex -> (..., W) real."""
    K = P[0].shape[-1]
    A, B = _inv_x_r2c_bank(w, W, kept_lo, keep_nyquist, K, P[0].dtype.name)
    return jnp.einsum(
        "...k,kn->...n", P[0], jnp.asarray(A), precision=precision
    ) + jnp.einsum("...k,kn->...n", P[1], jnp.asarray(B), precision=precision)


def inv_x_c2c(
    P: CPair, w: int, W: int, kept_lo: int, kept_hi: int, precision
) -> CPair:
    """Zero-band complex inverse over axis -1: (..., w) -> (..., W)."""
    D = _inv_x_c2c_bank(w, W, kept_lo, kept_hi, P[0].dtype.name)
    return _cc_contract(D, P, "kn,...k->...n", precision)


# ---------------------------------------------------------------------------
# collapsed two-matmul r2c chain
# ---------------------------------------------------------------------------
#
# The full r2c pipeline (R2C_x -> fwd_y -> zero-band inv_y -> C2R_x) is a
# linear map real^(h,w) -> real^(H,W).  Grouping by axis:
#
#   out = Ry ._y (img ._x alpha)  +  Iy ._y (img ._x beta)
#
# where alpha/beta compose the x banks (alpha = Cx@A + Sx@B — the real
# band-limited periodic-sinc interpolation matrix; beta its quadrature
# partner) and Ry/Iy are the real/imag parts of the composed y roundtrip.
# Iy vanishes except for spectrally unpaired bins (the relocated y-Nyquist,
# which the shift moves whole — VkResample.cpp:521-525), making it rank<=1;
# we factor it by SVD and append the r correction rows to the main y matmul.
# Net cost: TWO large real matmuls for the entire transform chain.


@lru_cache(maxsize=8)  # f64 staging matrices are tens of MB per geometry
def _r2c_chain_banks(
    h: int,
    w: int,
    H: int,
    W: int,
    kl_y: int,
    kh_y: int,
    kl_x: int,
    keep_nyq: bool,
    dtype: str,
):
    K = w // 2 + (1 if keep_nyq else 0)
    # x banks in f64
    n = np.arange(w)[:, None]
    k = np.arange(K)[None, :]
    ang = -2.0 * np.pi * n * k / w
    Cx, Sx = np.cos(ang), np.sin(ang)
    kk = np.arange(K)[:, None].astype(np.float64)
    nn = np.arange(W)[None, :]
    ang2 = 2.0 * np.pi * kk * nn / W
    c = np.full((K, 1), 2.0)
    c[0, 0] = 1.0
    keep = (np.arange(K) < kl_x).astype(np.float64)[:, None]
    bmask = keep.copy()
    if keep_nyq and K > w // 2:
        keep[w // 2, 0] = 1.0
        if w % 2 == 0:
            c[w // 2, 0] = 1.0  # true Nyquist: Re kept once, Im dropped
        else:
            bmask[w // 2, 0] = 1.0  # odd w: regular paired bin (c=2, Im kept)
    A = np.cos(ang2) * c * keep / w
    B = -np.sin(ang2) * c * bmask / w
    alpha = Cx @ A + Sx @ B  # (w, W)
    beta = Cx @ B - Sx @ A

    # y roundtrip composite (h, H) complex
    j = np.arange(h)
    t = np.arange(h)
    Df = np.exp(-2j * np.pi * np.outer(t, j) / h)  # fwd: F[j] = sum_t U[t] e^-
    sigma = np.where(j < kl_y, j, j - h).astype(np.float64)
    keep_y = ((j < kl_y) | (j >= h - kh_y)).astype(np.float64)
    DY = (
        np.exp(2j * np.pi * np.outer(sigma, np.arange(H)) / H)
        * keep_y[:, None]
        / h
    )
    comp = Df @ DY  # (h, H)
    Ry = np.real(comp)
    Iy = np.imag(comp)

    # factor the (near-)rank-1 imaginary residue.  For the standard band
    # geometry Iy is EXACTLY rank 1 (only the unpaired relocated y-Nyquist
    # bin contributes an imaginary part), so try direct cross extraction
    # first — an O(h*H) check instead of an SVD that takes minutes at
    # 4096x8192 (the big dense-int8 tier's geometry); SVD remains the
    # fallback for any non-rank-1 geometry.
    smax = np.abs(Iy).max()
    if smax < 1e-9:
        Y1 = np.zeros((h, 0))
        Y2 = np.zeros((0, H))
    else:
        m0 = int(np.argmax(np.abs(Iy).max(axis=0)))
        u_col = Iy[:, m0]
        # v by least-squares projection, not single-row division: the
        # projection averages the O(h*eps) rounding noise of the complex
        # Df@DY partial sums down by sqrt(h) — single-row extraction at
        # h=4096 leaves ~4e-10 junk in the sample columns, which breaks
        # the downstream y sample-row identity assert.
        v_row = (u_col @ Iy) / float(u_col @ u_col)
        # acceptance tolerance with an absolute floor for the same noise —
        # a pure relative bound spuriously rejects the exactly-rank-1
        # geometry and silently falls back to the minutes-long SVD
        tol = max(1e-12 * smax, 8.0 * h * np.finfo(np.float64).eps)
        if np.abs(Iy - np.outer(u_col, v_row)).max() <= tol:
            # zero sub-noise v entries (the true factor's zero columns)
            v_row = np.where(
                np.abs(v_row) * np.abs(u_col).max() <= tol, 0.0, v_row
            )
            Y1 = u_col[:, None]
            Y2 = v_row[None, :]
        else:
            U_, s_, Vt_ = np.linalg.svd(Iy, full_matrices=False)
            r = int(np.sum(s_ > 1e-10 * s_[0]))
            Y1 = U_[:, :r] * s_[:r]
            Y2 = Vt_[:r]
    return (
        alpha.astype(dtype),
        beta.astype(dtype),
        Ry.astype(dtype),
        Y1.astype(dtype),
        Y2.astype(dtype),
    )


def c2c_chain_banks(plan, dtype: str) -> dict:
    """Collapsed c2c chain: both the x and y roundtrips are fully C-linear,
    so each axis composes into ONE complex matrix —
    Xc (w, W) = Dfwd_x @ DXinv_band, Yc (h, H) = Dfwd_y @ DYinv_band.
    The real input makes the x pass 2 real matmuls; y is 3 (Karatsuba):
    five matmuls for the whole c2c transform chain."""
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    # x composite
    i_ = np.arange(w)[:, None]
    k_ = np.arange(w)[None, :]
    Fx = np.exp(-2j * np.pi * i_ * k_ / w)
    k = np.arange(w)
    sigma = np.where(k < plan.kept_lo_x, k, k - w).astype(np.float64)
    keep = (k < plan.kept_lo_x) | (k >= w - plan.kept_hi_x)
    DXinv = (
        np.exp(2j * np.pi * np.outer(sigma, np.arange(W)) / W)
        * keep.astype(np.float64)[:, None]
        / w
    )
    Xc = Fx @ DXinv  # (w, W)
    # y composite
    t_ = np.arange(h)[:, None]
    j_ = np.arange(h)[None, :]
    Fy = np.exp(-2j * np.pi * t_ * j_ / h)
    j = np.arange(h)
    sy = np.where(j < plan.kept_lo_y, j, j - h).astype(np.float64)
    keep_y = (j < plan.kept_lo_y) | (j >= h - plan.kept_hi_y)
    DYinv = (
        np.exp(2j * np.pi * np.outer(sy, np.arange(H)) / H)
        * keep_y.astype(np.float64)[:, None]
        / h
    )
    Yc = Fy @ DYinv  # (h, H)
    yr = np.real(Yc).astype(dtype)
    yi = np.imag(Yc).astype(dtype)
    return {
        "Xr": np.real(Xc).astype(dtype),
        "Xi": np.imag(Xc).astype(dtype),
        "Yr": yr,
        "Yi": yi,
        "Yrpyi": (yr + yi).astype(dtype),
    }


def c2c_chain(x: jnp.ndarray, banks: dict, precision) -> jnp.ndarray:
    """(..., h, w) real image -> (..., H, W) pre-CAS complex magnitude."""
    Ur = jnp.einsum("...hw,wn->...hn", x, banks["Xr"], precision=precision)
    Ui = jnp.einsum("...hw,wn->...hn", x, banks["Xi"], precision=precision)
    t1 = jnp.einsum("jm,...jn->...mn", banks["Yr"], Ur, precision=precision)
    t2 = jnp.einsum("jm,...jn->...mn", banks["Yi"], Ui, precision=precision)
    t3 = jnp.einsum(
        "jm,...jn->...mn", banks["Yrpyi"], Ur + Ui, precision=precision
    )
    yr = t1 - t2
    yi = t3 - t1 - t2
    return jnp.sqrt(yr * yr + yi * yi)


def r2c_chain_banks(plan, dtype: str) -> dict:
    """Numpy bank pytree for the collapsed r2c chain.

    Returned as a dict so callers can jax.device_put it and pass it as a
    jit ARGUMENT — multi-MB matrices must not become HLO literal constants
    (jax inlines trace-time numpy constants into the program text, which
    explodes compile payloads)."""
    alpha, beta, Ry, Y1, Y2 = _r2c_chain_banks(
        plan.h,
        plan.w,
        plan.H,
        plan.W,
        plan.kept_lo_y,
        plan.kept_hi_y,
        plan.kept_lo_x,
        plan.kept_hi_x > 0,
        dtype,
    )
    banks = {"alpha": alpha, "Ymat": np.concatenate([Ry, Y2], axis=0)}
    if Y1.shape[1]:
        banks["Y1"] = Y1
        banks["beta"] = beta
    return banks


def r2c_chain(x: jnp.ndarray, banks: dict, precision) -> jnp.ndarray:
    """(..., h, w) real image -> (..., H, W) pre-CAS real image in CAS
    units, via the collapsed two-matmul chain."""
    U = jnp.einsum("...hw,wn->...hn", x, banks["alpha"], precision=precision)
    if "Y1" in banks:
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jnp.einsum(
            "...hw,hr->...rw", x, banks["Y1"],
            precision=jax.lax.Precision.HIGHEST,
        )
        t2 = jnp.einsum("...rw,wn->...rn", tcorr, banks["beta"], precision=precision)
        U = jnp.concatenate([U, t2], axis=-2)
    return jnp.einsum("jm,...jn->...mn", banks["Ymat"], U, precision=precision)


# ---------------------------------------------------------------------------
# interleaved r2c fast path (integer factors)
# ---------------------------------------------------------------------------
#
# For an integer factor u with every y bin kept, zero-padding interpolation
# is EXACT at sample positions: out[u*t, u*s] reproduces in[t, s] up to the
# dropped x-Nyquist bin's (rank-1) contribution.  So the matmuls only need
# to produce the (u-1)/u non-sample columns and rows:
#
#   sample cols:  S = img - ((-1)^s / w) * q,  q = sum_i (-1)^i img[:, i]
#   other cols:   NS = img @ alpha_ns                     (w -> W - w)
#   weave U; sample rows: U itself (identity — the relocated y-Nyquist's
#   imaginary residue vanishes at integer sample rows: sin(pi(t+i)) = 0);
#   other rows:   O = Ymat_ns @ [U; corrections]          (h -> H - h)
#   weave rows -> (H, W)
#
# u=2 halves both contractions relative to r2c_chain.


def r2c_rows_supported(plan) -> bool:
    """Row-split fast path applies when sample output rows are exact: an
    integer factor with every y bin kept (always true for integer u on the
    reference band geometry)."""
    u = plan.integer_upscale
    return (
        plan.r2c
        and u is not None
        and u >= 2
        and plan.kept_lo_y + plan.kept_hi_y == plan.h
        and plan.H == u * plan.h
        and plan.W == u * plan.w
    )


def r2c_rows_banks(plan, dtype: str) -> dict:
    """Banks for the row-split fast path: full x matrix (output columns
    come out already woven) + y matrix restricted to NON-sample rows.
    Sample output rows are exact copies of the x-pass output (see
    r2c_rows_supported conditions)."""
    u = plan.integer_upscale
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    alpha, beta, Ry, Y1, Y2 = _r2c_chain_banks(
        h, w, H, W,
        plan.kept_lo_y, plan.kept_hi_y, plan.kept_lo_x, False, "float64",
    )
    Ymat = np.concatenate([Ry, Y2], axis=0)
    y_s = Ymat.reshape(-1, h, u)[:, :, 0]
    ident = np.zeros((Ymat.shape[0], h))
    ident[:h] = np.eye(h)
    if np.abs(y_s - ident).max() >= 1e-9:
        # explicit raise (not assert): stripped under python -O, and a
        # failure here means silently wrong images
        raise ValueError("y sample-row identity failed")
    # fold the /255 uint8 normalization (VkResample.cpp:1644) into the x
    # banks and split them into bf16 hi+lo terms: uint8 pixel values are
    # EXACT in bf16, so the x pass runs as TWO plain-bf16 passes with f32
    # accumulation — f32-grade accuracy from bf16 products.
    an = alpha / 255.0
    a_hi = an.astype("bfloat16" if dtype != "float64" else dtype)
    a_lo = (an - a_hi.astype(np.float64)).astype(
        "bfloat16" if dtype != "float64" else dtype
    )
    Ymat_ns = np.ascontiguousarray(
        Ymat.reshape(-1, h, u)[:, :, 1:].reshape(-1, h * (u - 1))
    )
    banks = {
        "alpha_hi": a_hi,
        "alpha_lo": a_lo,
        "Ymat_ns": Ymat_ns.astype(dtype),
    }
    r = Y1.shape[1]
    if r:
        banks["Y1n"] = (Y1 / 255.0).astype(dtype)
        banks["beta"] = beta.astype(dtype)
    if u == 2 and dtype != "float64":
        # quad-parity column split: output col 2s is EXACT up to a rank-1
        # x-Nyquist correction (alpha[:, 0::2] = I - outer((-1)^i,(-1)^s)/w,
        # verified to 5e-15), so the x matmul only needs the ODD columns —
        # half the matmul work.  /255 folded, split-bf16 hi|lo like alpha.
        aodd = alpha[:, 1::2] / 255.0
        ao_hi = aodd.astype("bfloat16")
        ao_lo = (aodd - ao_hi.astype(np.float64)).astype("bfloat16")
        banks["alpha_odd_hi"] = ao_hi
        banks["alpha_odd_lo"] = ao_lo
    if u == 2 and dtype != "float64" and _int8_banks_wanted(plan):
        # int8 digit banks (r2c_quad int8 route; int8 tensor-core
        # products run at 2x the bf16 rate).  x bank: three rounded
        # base-128 digits of alpha_odd (the 2^15 headroom keeps every
        # digit in int8; build-time check).  y bank: see
        # _int8_y_digit_banks.
        banks.update(_int8_x_digit_banks(aodd, "xq"))
        # full-width digits for the rows route (woven-output callers,
        # w % 128 != 0 geometries) — the y digit banks below are shared
        banks.update(_int8_x_digit_banks(an.astype(np.float64), "xqf"))
        banks.update(_int8_y_digit_banks(Ymat_ns[:h].astype(np.float64)))
    return banks


def _int8_x_digit_banks(A, key: str) -> dict:
    """Three rounded base-128 int8 digits of a 21-bit fixed-point
    rendering of the f64 x bank A (columns already /255-folded), plus the
    (x - 128) shift compensation row and the reconstruction scale.  The
    2^15 headroom in the scale keeps every digit in int8 (asserted)."""
    SCALE21 = float((1 << 21) - (1 << 15))
    SX = float(np.abs(A).max())
    Aq = np.round(A / SX * SCALE21).astype(np.int64)
    d1 = np.round(Aq / (1 << 14)).astype(np.int64)
    rem = Aq - (d1 << 14)
    d2 = np.round(rem / (1 << 7)).astype(np.int64)
    d3 = rem - (d2 << 7)
    if not all(
        -128 <= int(d.min()) and int(d.max()) <= 127
        for d in (d1, d2, d3)
        if d.size
    ):
        # explicit raise (not assert): stripped under python -O, and an
        # overflow would silently wrap in the int8 cast -> corrupt banks
        raise ValueError("x digit overflow")
    scale = SX / SCALE21
    Arec = (d1.astype(np.float64) * (1 << 14) + d2 * (1 << 7) + d3) * scale
    return {
        key + "_d1": d1.astype(np.int8),
        key + "_d2": d2.astype(np.int8),
        key + "_d3": d3.astype(np.int8),
        key + "_corr": (128.0 * Arec.sum(axis=0)).astype("float32"),
        key + "_scale": np.float32(scale),
    }


def _int8_y_digit_banks(Ymain) -> dict:
    """int8 digit banks for the y contraction.

    Default: a 21-bit THREE-digit bank (the x bank's encoding, via
    _int8_x_digit_banks on Ymain/2^14) consumed by 5 int8 matmuls with
    NO residual pass (bank error ~0.01 u8 LSB).

    VKRESAMPLE_Y_DIGITS=2 keeps the two-digit form: exact shift/mask
    digits of the 15-bit fixed-point matrix + offset-digit constants +
    a bf16 residual that cancels the bank quantization (see
    _quad_int8_y for both algebras).  Resolved ONCE at bank-build time;
    the route dispatches on bank content."""
    import os

    if os.environ.get("VKRESAMPLE_Y_DIGITS", "3") != "2":
        # out = Y @ (Pq/2^14) with Pq = 256*ph + (pl + 128) (both exact
        # int8 digits of the stored int16 plane):
        #   Y@Pq = Arec@(256*ph + pl) + 128*colsum(Arec)
        # so building the digits of Ymain/2^14 folds the plane descale
        # into the bank scale, and _int8_x_digit_banks' corr row is
        # exactly the +128 offset compensation.
        return _int8_x_digit_banks(
            np.asarray(Ymain, np.float64) / 16384.0, "yq3"
        )
    SY = float(np.abs(Ymain).max())
    Yq = np.round(Ymain / SY * 16384.0).astype(np.int32)
    yqh = (Yq >> 8).astype(np.int8)  # exact: Yq in [-2^14, 2^14]
    yql = ((Yq & 255) - 128).astype(np.int8)  # exact offset digit
    return {
        "yq_h": yqh,
        "yq_lo": yql,
        "yq_comp": (
            32768.0 * yqh.astype(np.float64).sum(axis=0)
            + 128.0 * yql.astype(np.float64).sum(axis=0)
        ).astype("float32"),
        "yq_scale": np.float32(SY / (16384.0 * 16384.0)),
        "yq_res": (
            Ymain - SY * Yq.astype(np.float64) / 16384.0
        ).astype("bfloat16"),
    }


def _int8_banks_wanted(plan) -> bool:
    """Build the int8 digit banks only when the route can activate: the
    half-precision mode with int16 Q2.14 storage (the default) and no
    explicit opt-out.  SINGLE/DOUBLE and the f32/bf16 storage knobs never
    take the route, so building ~16 MB of digit banks there would only
    waste HBM and upload time."""
    import os

    from ..core.config import Precision

    return (
        plan.precision is Precision.HALF
        and not os.environ.get("VKRESAMPLE_NO_INT8")
        and os.environ.get("VKRESAMPLE_HALF_STORAGE") not in ("f32", "bf16")
        and os.environ.get("VKRESAMPLE_MM_PRECISION", "").lower() != "highest"
    )


def r2c_quad_int8_banks(plan, dtype: str = "float32") -> dict:
    """Minimal int8-only bank set for the BIG dense quad route (u=2 half
    mode beyond DENSE_MAX): x odd-column digit banks, y digit banks +
    bf16 residual, the rank-r y-Nyquist correction factors, and the
    parity-pre-split beta correction banks in bf16 — no f32/bf16 alpha or
    Ymat matrices (those would be 0.5-1 GB at 8192x16384).

    At 4096x8192 -> 8192x16384 this is ~250 MB of device banks and turns
    the frame into 3+8 int8 matmuls + quad CAS, vs the mixed-radix
    phases route's many-stage relayouts.  Detect this set by "xq_d1"
    present and
    "Ymat_ns" absent; it requires the int8 route (store codec + not
    HIGHEST)."""
    u = plan.integer_upscale
    if not (u == 2 and r2c_rows_supported(plan) and plan.w % 128 == 0):
        raise ValueError("big int8 quad banks require u=2 and w % 128 == 0")
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    alpha, beta, Ry, Y1, Y2 = _r2c_chain_banks(
        h, w, H, W,
        plan.kept_lo_y, plan.kept_hi_y, plan.kept_lo_x, False, "float64",
    )
    Ymat = np.concatenate([Ry, Y2], axis=0)
    y_s = Ymat.reshape(-1, h, u)[:, :, 0]
    ident = np.zeros((Ymat.shape[0], h))
    ident[:h] = np.eye(h)
    if np.abs(y_s - ident).max() >= 1e-9:
        raise ValueError("y sample-row identity failed")
    Ymat_ns = np.ascontiguousarray(
        Ymat.reshape(-1, h, u)[:, :, 1:].reshape(-1, h * (u - 1))
    )
    aodd = alpha[:, 1::2] / 255.0
    banks = _int8_x_digit_banks(aodd, "xq")
    banks.update(_int8_y_digit_banks(Ymat_ns[:h]))
    r = Y1.shape[1]
    if r:
        banks["Y1n"] = (Y1 / 255.0).astype(dtype)
        banks["Yc"] = np.ascontiguousarray(Ymat_ns[h:]).astype(dtype)
        banks["beta_e"] = np.ascontiguousarray(beta[:, 0::2]).astype("bfloat16")
        banks["beta_o"] = np.ascontiguousarray(beta[:, 1::2]).astype("bfloat16")
    return banks


def _use_int8(banks: dict, store, precision) -> bool:
    """int8 route applies on the half-precision quad path: the stored
    int16 planes make the activation digits exact shift/masks, and the
    mode's tolerance absorbs the ~0.01 u8 LSB the digit banks add.
    Precision HIGHEST (the VKRESAMPLE_MM_PRECISION=highest override)
    disables the route so the accuracy knob keeps meaning what it says.

    Decided from BANK CONTENT only (plus the precision argument), never
    from env vars: the env knobs are resolved once at bank-build time
    (_int8_banks_wanted), so the built banks and the traced route can
    never disagree within a process.  A/B
    harnesses that want the non-int8 arm strip the xq*/yq* keys from the
    bank dict instead of toggling env mid-process."""
    import jax as _jax

    return (
        store is not None
        and "xq_d1" in banks
        and precision is not _jax.lax.Precision.HIGHEST
    )


def _quad_int8_x(x_raw: jnp.ndarray, banks: dict, key: str = "xq") -> jnp.ndarray:
    """x matmul as three int8 passes (1.5 bf16-pass equivalents vs
    the 2-pass stacked bf16 hi|lo): uint8 pixels shift to exact int8 via
    (x - 128) with a precomputed rank-1 compensation; the bank is three
    rounded base-128 digits (21 bits).  key selects the digit-bank set:
    "xq" = odd output columns (quad route), "xqf" = full width (rows
    route)."""
    xs = (x_raw.astype(jnp.int32) - 128).astype(jnp.int8)

    def mm(dd):
        return jnp.einsum(
            "...hk,kn->...hn", xs, dd, preferred_element_type=jnp.int32
        ).astype(jnp.float32)

    acc = (
        mm(banks[key + "_d1"]) * jnp.float32(1 << 14)
        + mm(banks[key + "_d2"]) * jnp.float32(1 << 7)
        + mm(banks[key + "_d3"])
    )
    return acc * banks[key + "_scale"] + banks[key + "_corr"]


def _quad_int8_y(Pst: jnp.ndarray, banks: dict) -> jnp.ndarray:
    """Non-sample-row y matmul read straight from the STORED int16 Q2.14
    plane via exact int8 digits.  Dispatches on bank content:

    yq3_* (default): 21-bit 3-digit bank, 5 int8 passes, NO residual
    — the d3@pl cross product (2^-22 relative) is dropped; total error
    ~0.01 u8 LSB.

    yq_* (VKRESAMPLE_Y_DIGITS=2): 4 int8 passes + one bf16 residual pass
    that cancels the 15-bit bank quantization.  Digit algebra (both
    operands as d_hi*256 + (d_lo + 128), every digit exactly int8 for
    the full int16 range):
      sum Yq*Pq = 65536*yh.ph + 256*(yh.pl + yl.ph) + yl.pl
                + [32768*colsum(yh) + 128*colsum(yl)]   (bank constant)
                + 128 * colsum_j(Pq)                    (one cheap reduce)
    """
    pi = Pst.astype(jnp.int32)
    ph = (pi >> 8).astype(jnp.int8)
    pl = ((pi & 255) - 128).astype(jnp.int8)

    def mm(a, b):
        return jnp.einsum(
            "jm,...jn->...mn", a, b, preferred_element_type=jnp.int32
        )

    if "yq3_d1" in banks:
        acc = (
            mm(banks["yq3_d1"], ph).astype(jnp.float32)
            * jnp.float32(256.0 * (1 << 14))
            + mm(banks["yq3_d2"], ph).astype(jnp.float32)
            * jnp.float32(256.0 * (1 << 7))
            + mm(banks["yq3_d3"], ph).astype(jnp.float32) * jnp.float32(256.0)
            + mm(banks["yq3_d1"], pl).astype(jnp.float32)
            * jnp.float32(1 << 14)
            + mm(banks["yq3_d2"], pl).astype(jnp.float32) * jnp.float32(1 << 7)
        )
        return acc * banks["yq3_scale"] + banks["yq3_corr"][:, None]

    acc = mm(banks["yq_h"], ph).astype(jnp.float32) * jnp.float32(65536.0)
    acc = acc + (
        mm(banks["yq_h"], pl) + mm(banks["yq_lo"], ph)
    ).astype(jnp.float32) * jnp.float32(256.0)
    acc = acc + mm(banks["yq_lo"], pl).astype(jnp.float32)
    psum = jnp.sum(pi, axis=-2, keepdims=True).astype(jnp.float32)
    acc = acc + jnp.float32(128.0) * psum + banks["yq_comp"][:, None]
    out = acc * banks["yq_scale"]
    pb = (pi.astype(jnp.float32) * jnp.float32(1.0 / 16384.0)).astype(
        jnp.bfloat16
    )
    return out + jnp.einsum(
        "jm,...jn->...mn",
        banks["yq_res"],
        pb,
        preferred_element_type=jnp.float32,
    )


def r2c_x_only(x_raw: jnp.ndarray, banks: dict, precision):
    """x-pass of the row-split fast path.  x_raw holds RAW uint8 pixel
    values 0..255 (uint8 or float) — normalization is folded into the
    banks.  Returns (U, T2) where
    U  (..., h, W) = x-pass output == the SAMPLE output rows, and
    T2 (..., r, W) = y-Nyquist correction rows for the y matmul (None when
    the plan has no imaginary y residue)."""
    bank_dt = banks["alpha_hi"].dtype
    xb = x_raw.astype(bank_dt)
    acc = jnp.float64 if bank_dt == jnp.float64 else jnp.float32
    # single contraction over the stacked hi|lo banks: one MXU matmul with
    # internal accumulation (two separate einsums would materialize two
    # f32 partials and pay an extra full-size add pass)
    a_cat = jnp.concatenate([banks["alpha_hi"], banks["alpha_lo"]], axis=0)
    x_cat = jnp.concatenate([xb, xb], axis=-1)
    U = jnp.einsum(
        "...hk,kn->...hn", x_cat, a_cat, preferred_element_type=acc
    )
    return U, _x_nyq_corr(x_raw, banks, precision, acc)


def _x_nyq_corr(x_raw, banks: dict, precision, acc=None):
    """Rank-r y-Nyquist correction rows T2 (..., r, W) for the split
    paths, or None when the plan has no imaginary y residue."""
    if "Y1n" not in banks:
        return None
    if acc is None:
        acc = jnp.float32
    # rank-r correction: matrix-vector work, full f32 (XLA's CPU
    # backend has no three-pass bf16 matrix-vector dot)
    tcorr = jnp.einsum(
        "...hw,hr->...rw", x_raw.astype(acc), banks["Y1n"],
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.einsum(
        "...rw,wn->...rn", tcorr, banks["beta"], precision=precision
    )


def r2c_rows(x_raw: jnp.ndarray, banks: dict, precision, store=None, load=None):
    """Row-split fast path: r2c_x_only plus the non-sample y matmul.
    Returns (U, O) where
    U (..., h, W)          = x-pass output == the SAMPLE output rows, and
    O (..., h*(u-1), W)    = non-sample rows, O[t*(u-1)+k] = out[u*t+k+1].
    Weave with weave_rows (XLA) or fuse into the Pallas output kernel.

    store/load: optional pre-CAS storage codec — same staging trick as
    r2c_quad (U otherwise feeds two consumers and XLA materializes the
    f32 plane besides the stored one); returns stored planes when set.

    On the half/i16 path with u=2 the contractions run on the int8 MXU
    route (full-width "xqf" digit banks + the shared y digit banks) —
    same algebra as r2c_quad, see docs/MATH.md §8."""
    h = x_raw.shape[-2]
    int8_route = _use_int8(banks, store, precision) and "xqf_d1" in banks
    if int8_route:
        U = _quad_int8_x(x_raw, banks, "xqf")
        T2 = _x_nyq_corr(x_raw, banks, precision)
        Us = store(U)
        O = _quad_int8_y(Us, banks)
    else:
        U, T2 = r2c_x_only(x_raw, banks, precision)
        if store is None:
            Us, Um = U, U
        else:
            Us = store(U)
            Um = load(Us)
        Ym = banks["Ymat_ns"][:h]
        O = jnp.einsum("jm,...jn->...mn", Ym, Um, precision=precision)
    Yc = banks["Ymat_ns"][h:]
    if T2 is not None:
        O = O + jnp.einsum("rm,...rn->...mn", Yc, T2, precision=precision)
    if store is None:
        return Us, O
    return Us, store(O)


def r2c_quad(x_raw: jnp.ndarray, banks: dict, precision, store=None, load=None):
    """Quad-parity fast path (u=2).  x_raw holds RAW uint8 values 0..255.
    Returns the four pre-CAS parity planes, each (..., h, w):

      P00 = output (even rows, even cols) = x/255 - rank-1 x-Nyquist corr
      P01 = output (even rows, odd cols)  = x @ alpha_odd    [half-x matmul]
      P10 = output (odd rows, even cols)  = Ymat_ns^T @ P00 (+ rank-r corr)
      P11 = output (odd rows, odd cols)   = Ymat_ns^T @ P01 (+ rank-r corr)

    Even output columns are exact samples up to the rank-1 correction
    (alpha[:, 0::2] = I - outer((-1)^i, (-1)^s)/w), and even output rows
    are exact x-pass rows (r2c_rows_supported identity) — so the full
    transform chain is ONE half-width x matmul + the y matmul, and no
    woven image ever exists (the PNG encoder interleaves both axes).

    store/load: optional pre-CAS storage codec (e.g. int16 Q2.14).  When
    given, every returned plane is store()d AND the y matmul reads the
    load()ed even-row planes instead of their f32 originals.  That single
    choice removes the f32 planes entirely: with store applied only
    afterwards, P00/P01 feed two consumers (storage + y matmul) and XLA
    must materialize 50 MB of f32 besides the stored planes at the
    flagship shape; the staging error (2 Q2.14 ticks = 0.03 u8 LSB) is far
    below the matmul's own operand rounding.

    The rank-r y-Nyquist correction rows are contracted separately and
    added (fused into the matmul epilogue) rather than concatenated onto
    the planes — the aug-concat copies 2x25 MB for r==1 rows."""
    w = x_raw.shape[-1]
    h = x_raw.shape[-2]
    acc = jnp.float32
    int8_route = _use_int8(banks, store, precision)
    if not int8_route and "alpha_odd_hi" not in banks:
        raise ValueError(
            "this bank set is int8-only (big dense quad tier) — it "
            "requires half mode with int16 storage and no "
            "VKRESAMPLE_NO_INT8/MM_PRECISION=highest override"
        )
    if int8_route:
        P01 = _quad_int8_x(x_raw, banks)
    else:
        xb = x_raw.astype(banks["alpha_odd_hi"].dtype)
        a_cat = jnp.concatenate(
            [banks["alpha_odd_hi"], banks["alpha_odd_lo"]], axis=0
        )
        # stacked hi|lo bank: ONE matmul with internal accumulation instead
        # of two einsums and an add over the output
        x_cat = jnp.concatenate([xb, xb], axis=-1)
        P01 = jnp.einsum(
            "...hk,kn->...hn", x_cat, a_cat, preferred_element_type=acc
        )
    xf = x_raw.astype(acc)
    signs = jnp.asarray((-1.0) ** np.arange(w), acc)
    q = jnp.sum(xf * signs, axis=-1, keepdims=True)  # (..., h, 1)
    P00 = xf * jnp.asarray(1.0 / 255.0, acc) - (signs * q) * jnp.asarray(
        1.0 / (255.0 * w), acc
    )
    t2e = t2o = None
    if "Y1n" in banks:
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jnp.einsum(
            "...hw,hr->...rw", xf, banks["Y1n"],
            precision=jax.lax.Precision.HIGHEST,
        )
        if "beta_e" in banks:
            # big int8-only bank set: beta pre-split by output column
            # parity in bf16 (a full f32 beta would be 0.5 GB at 16K)
            tb = tcorr.astype(jnp.bfloat16)
            t2e = jnp.einsum(
                "...rw,wn->...rn", tb, banks["beta_e"],
                preferred_element_type=acc,
            )
            t2o = jnp.einsum(
                "...rw,wn->...rn", tb, banks["beta_o"],
                preferred_element_type=acc,
            )
        else:
            t2 = jnp.einsum(
                "...rw,wn->...rn", tcorr, banks["beta"], precision=precision
            )
            t2e, t2o = t2[..., 0::2], t2[..., 1::2]
    if store is None:
        P00s, P01s = P00, P01
    else:
        P00s, P01s = store(P00), store(P01)
    if int8_route:
        import os

        if os.environ.get("VKRESAMPLE_DENSE_YBATCH") == "1":
            # item-7 experiment: one batched digit-dot set over the two
            # planes (5 MXU dispatches instead of 10) — the stack is a
            # 12.6 MB i16 copy at the flagship shape
            Pb = _quad_int8_y(jnp.stack([P00s, P01s]), banks)
            P10, P11 = Pb[0], Pb[1]
        else:
            P10 = _quad_int8_y(P00s, banks)
            P11 = _quad_int8_y(P01s, banks)
    else:
        P00m = P00 if store is None else load(P00s)
        P01m = P01 if store is None else load(P01s)
        Ym = banks["Ymat_ns"][:h]
        P10 = jnp.einsum("jm,...jn->...mn", Ym, P00m, precision=precision)
        P11 = jnp.einsum("jm,...jn->...mn", Ym, P01m, precision=precision)
    if t2e is not None:
        Yc = banks["Yc"] if "Yc" in banks else banks["Ymat_ns"][h:]
        P10 = P10 + jnp.einsum("rm,...rn->...mn", Yc, t2e, precision=precision)
        P11 = P11 + jnp.einsum("rm,...rn->...mn", Yc, t2o, precision=precision)
    if store is None:
        return P00s, P01s, P10, P11
    return P00s, P01s, store(P10), store(P11)


def weave_rows(U: jnp.ndarray, O: jnp.ndarray, u: int) -> jnp.ndarray:
    """Interleave sample rows U with non-sample row groups O -> (..., H, W)."""
    h, W = U.shape[-2], U.shape[-1]
    O4 = O.reshape(O.shape[:-2] + (h, u - 1, W))
    out = jnp.concatenate([U[..., :, None, :], O4], axis=-2)
    return out.reshape(out.shape[:-3] + (u * h, W))
