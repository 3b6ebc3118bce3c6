"""Staged circulant-convolution transform: the big-tier any-size engine.

The u=2 zero-band upscale's two hot contractions are exactly CIRCULANT:

  - the composed y roundtrip restricted to non-sample (odd) output rows is
    Ymat_ns[t, s] = Re phi(2(s-t)+1) with
    phi(d) = (1/h) sum_j keep(j) e^{i pi sigma(j) d / h}
    (shift-invariance of the band-limited interpolation kernel; the same
    composition VkFFT realizes as fwd FFT -> zero-band inverse,
    /root/reference/vkFFT/vkFFT.h:4733-4771), and
  - the odd-output-column x matrix alpha_odd[i, s] = psi(2(s-i)+1) is the
    same structure along the lane axis (no x-Nyquist column on the u=2
    band, so it is exactly band-limited hence exactly circulant).

So instead of one dense O(n^2) matmul per axis (the dense tier, which
needs O(n^2) bank bytes and caps at DENSE_INT8_MAX), each axis is a
length-n circular convolution evaluated by a two-level Cooley-Tukey
factorization n = n1*n2 as THREE batched small matmuls — the matmul
equivalent of VkFFT's multi-upload 4-step FFT (vkFFT.h:2205-2389: the
inter-pass twiddles), with the twiddles AND the kernel's eigenvalues
folded into the middle stage's per-k2 banks:

  t = t1 + n1*t2,  k = k2 + n2*k1
  S1 (fwd DFT over t2):   Y[t1,k2]  = sum_t2  x[t1+n1*t2] W2[t2,k2]
  S2 (per-k2 n1 x n1):    Z[t1',k2] = sum_t1  M[k2][t1,t1'] Y[t1,k2]
     M[k2][t1,t1'] = (1/n1) sum_k1 e^{-2pi i t1(k2/n + k1/n1)}
                     Lam[k2+n2*k1] e^{+2pi i t1'(k1/n1 + k2/n)}
  S3 (inv DFT over k2):   out[t1'+n1*t2'] = (1/n2) sum_k2 Z[t1',k2]
                                            e^{+2pi i t2' k2 / n2}

FLOPs drop O(n) -> O(n1 + 2*n2) per element and bank bytes O(n^2) ->
O(n*n1): at 4096x8192 -> 8192x16384 the y stage goes from a 4096^2 int8
digit matmul (~250 MB of banks, minutes of host staging) to three f32
matmuls with ~4 MB of banks built in milliseconds — and the 16384 cap
disappears (any composite n with a factor ~128 works, covering every
7-smooth size the scheduler accepts).

Both convolutions are REAL kernels applied to real planes.  The complex
stage arithmetic rides as an explicit size-2 tensor dimension in the
banks ("real block" form), so each stage is ONE einsum over real data —
three passes total, real in / real out, no Karatsuba adds and no complex
packing of the activations (the stacked spectral intermediate is the
only inherent 2x).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# kernel columns (numpy, O(n log n) — no O(n^2) matrix ever materializes)
# ---------------------------------------------------------------------------


def _odd_kernel(n: int, g: np.ndarray) -> np.ndarray:
    """c[d] = (1/n) sum_k g[k] e^{i pi sigma(k) (2d+1) / n} for the
    half-sample-offset (odd output) lattice, as one length-n ifft:
    sigma(k) == k (mod n) makes the d-dependent factor e^{2pi i k d/n}."""
    return np.fft.ifft(g)


def y_kernel(h: int, kept_lo: int, kept_hi: int):
    """Odd-output-row y kernel c (real, (h,)) and the rank-1 relocated
    y-Nyquist imaginary residue a0 with Iy_odd[t, s] = a0 * (-1)^(s-t)
    (a0 == 0 when every kept bin is +/- paired).  Mirrors the band
    geometry of dense._r2c_chain_banks' comp = Df @ DY."""
    j = np.arange(h)
    sigma = np.where(j < kept_lo, j, j - h).astype(np.float64)
    keep = (j < kept_lo) | (j >= h - kept_hi)
    g = keep.astype(np.float64) * np.exp(1j * np.pi * sigma / h)
    c = _odd_kernel(h, g)
    im = np.imag(c)
    a0 = float(im[0])
    # the imaginary residue must be the pure Nyquist tone a0*(-1)^d for
    # the rank-1 correction path to be exact (true for the reference u=2
    # band); anything else means the caller must not use this route
    if np.abs(im - a0 * (-1.0) ** np.arange(h)).max() > 1e-12:
        raise ValueError("y imaginary residue is not rank-1")
    return np.real(c), a0


def x_kernels(w: int, kept_lo: int):
    """Odd-output-column kernels (each real, (w,)) for the three x-axis
    circulants of the u=2 band (x-Nyquist dropped, mirroring
    dense.r2c_rows_banks' keep_nyq=False):

      psi_o: alpha[:, 1::2] rows  (the main odd-column interpolation)
      chi_o: beta[:, 1::2]        (odd-column quadrature partner)
      chi_e: beta[:, 0::2]        (even-column quadrature partner)

    alpha/beta relation: alpha[i, n] = psi(n - 2i), beta[i, n] = chi(n-2i)
    with psi(d) = (1/w) sum_sym keep e^{i pi sigma d / w} and
    chi(d) = (1/w) sum_sym (i sign sigma) keep e^{i pi sigma d / w}."""
    k = np.arange(w)
    sigma = np.where(k < kept_lo, k, k - w).astype(np.float64)
    keep = ((k < kept_lo) | (k > w - kept_lo)).astype(np.float64)
    g_alpha = keep * np.exp(1j * np.pi * sigma / w)
    g_beta = 1j * np.sign(sigma) * g_alpha
    psi_o = _odd_kernel(w, g_alpha)
    chi_o = _odd_kernel(w, g_beta)
    # even-offset lattice: no half-sample phase
    chi_e = np.fft.ifft(1j * np.sign(sigma) * keep)
    for v in (psi_o, chi_o, chi_e):
        if np.abs(np.imag(v)).max() > 1e-12:
            raise ValueError("x kernel not real — band not symmetric")
    return np.real(psi_o), np.real(chi_o), np.real(chi_e)


def phase_y_kernel(h: int, kept_lo: int, kept_hi: int, ry: int, u):
    """Per-phase y kernel for factor u (int, or Fraction p/q for the
    fractional tier): the composed y roundtrip restricted to output rows
    T with T = p*m + ry (q=1: u*m + ry) is circulant-at-stride-q with

      c_ry(d) = (1/h) sum_j keep(j) e^{2 pi i sigma(j) (d + ry/u) / h}

    evaluated at d = q*m - t (the section-4 phase twiddle
    ty_ry[j] = e^{2 pi i sigma(j) ry / H}, docs/MATH.md, folded into the
    roundtrip; sigma(j) == j mod h makes the d-dependence a plain ifft;
    the stride-q sampling is the consumer's decimation, see conv_banks).
    Returns (real kernel (h,), a0) where the imaginary residue is the
    pure relocated-Nyquist tone a0 * (-1)^d (a0 = 0 at ry = 0: the
    sample rows are the identity).  y_kernel is the (ry=1, u=2)
    specialization."""
    from fractions import Fraction

    uf = Fraction(u)
    p, q = uf.numerator, uf.denominator
    j = np.arange(h)
    sigma = np.where(j < kept_lo, j, j - h).astype(np.float64)
    keep = (j < kept_lo) | (j >= h - kept_hi)
    g = keep.astype(np.float64) * np.exp(
        2j * np.pi * sigma * (ry * q) / (p * h)
    )
    c = np.fft.ifft(g)
    im = np.imag(c)
    a0 = float(im[0])
    if np.abs(im - a0 * (-1.0) ** np.arange(h)).max() > 1e-12:
        raise ValueError("y imaginary residue is not rank-1")
    return np.real(c), a0


def phase_x_kernels(w: int, kept_lo: int, rx: int, u):
    """Per-phase x kernels for factor u (int or Fraction p/q): output
    columns S = p*m + rx, sampled at stride q of the circulant below.

      psi_rx(d) = (1/w) sum_sym keep e^{2 pi i sigma (d + rx/u) / w}
      chi_rx(d) = same with i*sign(sigma) weights (the quadrature partner
                  that couples to the y-Nyquist imaginary residue — see
                  dense.py's `out = Ry (img alpha) + Iy (img beta)`)

    The x band is symmetric with the Nyquist dropped, so both kernels are
    exactly real at every offset; psi_0 = delta - (1/w)(-1)^d (the exact
    sample-column identity + rank-1 x-Nyquist correction).  x_kernels is
    the u=2 specialization (psi_1, chi_1, chi_0)."""
    from fractions import Fraction

    uf = Fraction(u)
    p, q = uf.numerator, uf.denominator
    k = np.arange(w)
    sigma = np.where(k < kept_lo, k, k - w).astype(np.float64)
    keep = ((k < kept_lo) | (k > w - kept_lo)).astype(np.float64)
    g_alpha = keep * np.exp(2j * np.pi * sigma * (rx * q) / (p * w))
    g_beta = 1j * np.sign(sigma) * g_alpha
    psi = np.fft.ifft(g_alpha)
    chi = np.fft.ifft(g_beta)
    for v in (psi, chi):
        if np.abs(np.imag(v)).max() > 1e-12:
            raise ValueError("x kernel not real — band not symmetric")
    return np.real(psi), np.real(chi)


# ---------------------------------------------------------------------------
# staged banks
# ---------------------------------------------------------------------------


def split_factors(n: int, prefer: int = None, multiple_of: int = 1):
    """Pick n1 (the middle-stage contraction size) as the divisor of n
    closest to `prefer` (ties toward the larger), n2 = n // n1.  Returns
    None when no usable split exists (prime or near-prime n).

    Default prefer is sqrt(n) — the BALANCED split: S1/S3 contract only
    K = n2 / 2*(n2/2+1), so a large n1 leaves those two stages with a
    shallow contraction while also RAISING total FLOPs (S2 is
    n1-linear); sqrt(n) balances K across stages.  Which split is
    fastest on the H100 is unmeasured.

    multiple_of: constrain n1 to multiples of this (the fractional
    tier's stride-q decimation lives on the t1' axis, so it needs
    q | n1 — see conv_banks' decimate)."""
    if prefer is None:
        # sqrt(n) capped at 64
        prefer = max(8, min(64, int(round(float(np.sqrt(n))))))
    best = None
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d:
            continue
        for cand in (d, n // d):
            if cand < 8 or n // cand < 4 or cand % multiple_of:
                continue
            score = (abs(cand - prefer), -cand)
            if best is None or score < best[0]:
                best = (score, cand)
    if best is None:
        return None
    n1 = best[1]
    return n1, n // n1


def x_split_prefer(decimate: int = 1, n: int = None) -> int:
    """Preferred middle factor n1 for the LANES (x-axis) staged convs.

    n1=128 makes BOTH the input view (..., n2, 128) and the natural
    "...ed" S3 output view of the lanes conv 128-element-exact in its
    minor dim, so the flatten at the x->y boundary needs no relayout
    copy in a layout tiled by 128 along the minor dim.
    Decimated (fractional) banks emit nd = n1/q output columns, so the
    lane-exact preference scales to n1 = 128*q: the input view's minor
    dim stays a multiple of 128 and the output's nd lands exactly on
    128.

    When the axis length `n` is given, n1 additionally doubles (staying
    a divisor) until n2 = n/n1 <= 64 (at w=16384 the n1=128 split's
    n2=128 re-introduces boundary relayouts).  VKRESAMPLE_XSPLIT
    overrides the base (pre-q) preference for A/B.  The H100's best
    split is unmeasured.

    Widths 128*q does NOT divide (e.g. 8640 = 2^6*3^3*5 — no divisor is
    a multiple of 128): no lane-exact split exists, so pick the divisor
    whose padded-vreg waste is smallest — each stage view's minor dim
    (n1 on the input/S1 side, nd = n1/q on the output/S3 side) rounds up
    to the next 128 lanes, so the wasted-lane fraction is
    (ceil(d/128)*128 - d)/d summed over both views; ties break toward
    the value closest to 128*q, then larger.  At 8640 this lands on
    n1=120 (pads to 128, 6.7% per view) instead of split_factors'
    closest-divisor default of 135 (pads to 256, 90%).  The reference
    schedules any 7-smooth size without an alignment requirement
    (vkFFT.h:4707-5189); this keeps such widths on the staged tier at a
    modest lane-padding tax instead of the ~7x phases route."""
    import os

    base = 128
    v = os.environ.get("VKRESAMPLE_XSPLIT")
    if v:
        return int(v) * decimate
    n1 = base * decimate
    if n:
        if n % n1 == 0:
            while n % (2 * n1) == 0 and n // n1 > 64:
                n1 *= 2
        else:
            # restrict to the matmul-efficient window (S2's FLOPs are
            # n1-linear per element and its banks O(n1^2) bytes, so huge
            # divisors minimize relative padding while losing outright
            # on work); outside the window fall back to split_factors'
            # closest-to-128q default
            best = None
            lo, hi = 64 * decimate, 320 * decimate
            for d in range(decimate, n + 1, decimate):
                if n % d or d < max(8, lo) or d > hi or n // d < 4:
                    continue
                waste = (-d % 128) / d + (-(d // decimate) % 128) / (
                    d // decimate
                )
                score = (round(waste, 6), abs(d - 128 * decimate), -d)
                if best is None or score < best[0]:
                    best = (score, d)
            if best is not None:
                n1 = best[1]
    return n1


def y_split_prefer():
    """Preferred middle factor n1 for the ROWS (y-axis) staged convs —
    None keeps split_factors' balanced default (sqrt capped 64, the
    measured best at 4K/8K heights).  VKRESAMPLE_YSPLIT overrides for
    A/B at geometries whose row count makes n2 large (h=8192 gives
    n2=128 at the default)."""
    import os

    v = os.environ.get("VKRESAMPLE_YSPLIT")
    return int(v) if v else None


def conv_banks(
    kernel: np.ndarray,
    prefix: str,
    n1: int = None,
    dtype: str = "float32",
    prefer: int = None,
    decimate: int = 1,
) -> dict:
    """Bank dict for one staged circular convolution with the given
    real kernel column: out[s] = sum_t kernel[(s-t) mod n] x[t].

    decimate=q keeps only outputs s = q*m (the fractional tier's
    stride-q sampling lattice): since s = t1' + n1*t2' and q | n1,
    restricting the middle stage's t1' axis to multiples of q yields
    exactly the decimated outputs — conv_apply_* then return length
    n/q arrays indexed by m = t1'/q + (n1/q)*t2', i.e. out[q*m] in
    order, with the skipped outputs never computed."""
    n = kernel.shape[0]
    if n1 is None:
        split = split_factors(n, prefer, multiple_of=decimate)
        if split is None:
            raise ValueError(f"no usable Cooley-Tukey split for n={n}")
        n1, n2 = split
    else:
        n2 = n // n1
    if n1 % decimate:
        raise ValueError(f"decimate {decimate} must divide n1 {n1}")
    lam = np.fft.fft(kernel.astype(np.float64))  # circulant eigenvalues
    t2 = np.arange(n2)
    w2f = np.exp(-2j * np.pi * np.outer(t2, t2) / n2)  # (t2, k2)
    w2i = np.exp(2j * np.pi * np.outer(t2, t2) / n2) / n2  # (k2, t2')
    t1 = np.arange(n1)
    k1 = np.arange(n1)
    w1f = np.exp(-2j * np.pi * np.outer(t1, k1) / n1)  # (t1, k1)
    w1i = np.exp(2j * np.pi * np.outer(k1, t1) / n1) / n1  # (k1, t1')
    # lam viewed as (k1, k2): k = k2 + n2*k1
    lam2 = lam.reshape(n1, n2)
    # M[k2, t1, t1'] = sum_k1 tw*(t1,k2) W1f[t1,k1] lam2[k1,k2] W1i[k1,t1'] tw(t1',k2)
    tw = np.exp(-2j * np.pi * np.outer(t1, t2) / n)  # (t1, k2) twiddle
    M = np.einsum("ac,ak,kc,kb,bc->cab", tw, w1f, lam2, w1i, np.conj(tw))

    # REAL BLOCK banks: re/im ride as an explicit size-2 tensor dim so the
    # whole conv is THREE einsums over real data (one per stage) with no
    # Karatsuba adds and no complex packing of the activations — real in,
    # real out.  The input is REAL, so the t2-spectrum is Hermitian in k2
    # and only bins k2 in [0, n2/2] are computed (the half-spectrum pair
    # weights fold into the inverse bank) — the spectral intermediates
    # and the middle stage's FLOPs halve EXACTLY.
    #   b1 (t2, 2, k2h):         [cos, sin] of the forward t2-DFT
    #   m  (k2h, 2, t1, 2, t1'): complex M as a 2x2 real block
    #   b3 (2, k2h, t2'):        weighted real part of the inverse k2-DFT
    kh = n2 // 2 + 1
    b1 = np.stack([np.real(w2f), np.imag(w2f)], axis=1)[:, :, :kh]
    if decimate > 1:
        # keep only output columns t1' = q*m1 (see docstring)
        M = M[:, :, ::decimate]
    nd = n1 // decimate
    mb = np.empty((kh, 2, n1, 2, nd))
    mr, mi = np.real(M[:kh]), np.imag(M[:kh])
    mb[:, 0, :, 0, :] = mr
    mb[:, 1, :, 0, :] = -mi
    mb[:, 0, :, 1, :] = mi
    mb[:, 1, :, 1, :] = mr
    pair_w = np.full((kh, 1), 2.0)
    pair_w[0, 0] = 1.0
    if n2 % 2 == 0:
        pair_w[n2 // 2, 0] = 1.0
    b3 = np.stack(
        [np.real(w2i[:kh]) * pair_w, -np.imag(w2i[:kh]) * pair_w], axis=0
    )
    # static per-stage magnitude bounds for the experimental i16
    # intermediate codec: |S1| <= g1 * max|x| (worst-case L1 row norm of
    # the S1 contraction), |S2| <= g1 * g2 * max|x|.  Tiny (2,) array so
    # the bounds ride the banks dict through jit as scalars.
    g1 = float(np.abs(b1).sum(axis=0).max())
    g2 = float(np.abs(mb).sum(axis=(1, 2)).max())
    return {
        prefix + "b1": b1.astype(dtype),
        prefix + "m": mb.astype(dtype),
        prefix + "b3": b3.astype(dtype),
        prefix + "qb": np.asarray([g1, g1 * g2], dtype),
        # exact DC gain sum_d kernel[d] (the bf16c centered mode's
        # add-back scale: conv(x) = conv(x - cm) + cm * dc0)
        prefix + "dc0": np.asarray(kernel.sum(), dtype),
    }


def _intermediate_mode(b1):
    """VKRESAMPLE_STAGED_INTERMEDIATE knob for the inter-stage spectral
    buffers (halving the inter-stage bytes is the traffic lever where
    the convs are memory-bound):

    'bf16'      — bf16 intermediates AND single-pass bf16 stage matmuls
                  with f32 accumulation.  REJECTED for default use:
                  measured ~2.5 u8 LSB deviation (158 Q2.14 units at
                  96x384, tests/test_staged.py) — the random walk of
                  2^-9 operand roundings over K~128 contractions is ~1%,
                  inherent to single-pass bf16 at these sizes.
    'bf16store' — bf16 ONLY for the materialized intermediates; the
                  stage matmuls keep the caller's precision on the
                  upcast values.  Error is two storage
                  roundings per element instead of a K-step random walk.
                  ALSO REJECTED for default use: measured ~2.2-2.4 u8
                  LSB (140 Q2.14 units at 96x384, 154 at 256x1024) vs
                  full f32 — the spectral intermediates' dynamic range
                  (DC-heavy bins feed every output element through the
                  inverse stages) makes even pure storage rounding at
                  2^-9 relative overshoot the 1-LSB gate.
    'i16'       — int16 intermediates at static per-stage L1-norm
                  bounds (the banks' `qb` entries × the call site's
                  input max): ABSOLUTE resolution, so the error does
                  not follow the DC bins' magnitude the way bf16's
                  relative rounding does — measured 0.33-0.55 u8 LSB on
                  CPU at small sizes.  Not the default: where XLA fuses
                  S2→S3, no spectral intermediate exists there to
                  shrink and the codec CREATES one; the per-boundary
                  split (VKRESAMPLE_I16_STAGES "0"/"1"/"01") selects
                  which boundaries store int16.  Its speed on the H100
                  is unmeasured.

    'bf16c'     — CENTERED bf16: subtract the per-column (rows conv) /
                  per-row (lanes conv) mean before the stages, run the
                  stages on bf16 operands (banks cast to bf16, single
                  bf16 pass, f32 accumulation), add the mean back after
                  S3.  Every staged kernel has exact unit DC gain
                  (sum_d c[d] = g[0] = keep[0] = 1), so the add-back is
                  exact — and the centering removes the DC magnitude
                  that made modes (a)/(b) overshoot: bf16's relative
                  rounding then acts on the zero-mean signal only.

    All modes stay for looser-tolerance bandwidth work.
    """
    import os

    v = os.environ.get("VKRESAMPLE_STAGED_INTERMEDIATE")
    if v in ("bf16", "bf16store", "i16", "bf16c") and b1.dtype == jnp.float32:
        return v
    return None


def _i16_store(y, bound):
    """Quantize a spectral intermediate to int16 at the static worst-case
    magnitude `bound` (a traced scalar from the banks' `qb` entries ×
    the call site's input max) and dequantize — the materialized
    inter-stage buffer becomes i16, the consumer sees f32."""
    s = 32767.0 / bound.astype(jnp.float32)
    q = jnp.clip(jnp.round(y * s), -32767.0, 32767.0).astype(jnp.int16)
    return q.astype(jnp.float32) / s


def _i16_stages():
    """Which inter-stage boundaries the i16 mode quantizes (trace-time
    env VKRESAMPLE_I16_STAGES, default both): "01", "0" (S1->S2 only)
    or "1" (S2->S3 only) — per-boundary attribution for the A/B."""
    import os

    v = os.environ.get("VKRESAMPLE_I16_STAGES", "01")
    return {int(c) for c in v if c in "01"}


def conv_apply_rows(
    x, banks: dict, prefix: str, precision=None, dc_add=None, in_max=None,
    load=None, epilogue=None,
):
    """Staged circular convolution over axis -2 of a REAL array
    (..., n, L) -> (..., n, L).

    dc_add: optional (..., n1, L) term injected into the DC bin's real
    part between S2 and S3 — adds dc_add[d, L] to EVERY output row group
    t2' (b3[0, 0, e] = 1/n2 for all e).  Used to fold the rank-1
    y-Nyquist correction into the SMALL spectral intermediate so the i16
    store can fuse into S3's epilogue instead of paying a full-size
    post-add pass.

    load: optional storage-codec decode — x arrives in STORED form
    (e.g. int16 Q2.14) and is decoded AFTER the internal row-split
    reshape.  load(reshape(x)) == reshape(load(x)) bit-exactly
    (elementwise op), but the deferred order halves the relayout bytes
    when the reshape materializes and lets the dequant fuse into S1's
    operand read instead of a separate full-size dequant pass.

    epilogue: optional elementwise function applied to the output in
    its pre-flatten 4D view (..., e, d, L), e of size n2 (row-group)
    and d of size nd, output row s = e*nd + d.  Runs AFTER dc_add/the
    bf16c DC add-back.  Broadcast terms indexed by output row must be
    reshaped to (n2, nd, 1) by the caller.  Fusing row-broadcast math
    (and a storage encode) here instead of post-flatten lets it ride
    S3's emission BEFORE the sublane-transpose layout copy the flatten
    pays, so the copy moves to the (narrow) epilogue output instead of
    materialized f32 reshapes plus a separate encode pass (the c2c
    magnitude pass uses this)."""
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    b1 = banks[prefix + "b1"]
    mb = banks[prefix + "m"]
    b3 = banks[prefix + "b3"]
    kw = {}
    prec23 = precision
    mode = _intermediate_mode(b1)
    if load is not None and mode in ("bf16", "bf16c"):
        # these modes transform x globally (cast / centering) before the
        # split — decode up front, exactly as the caller used to
        x = load(x)
        load = None
    cm = None
    if mode == "bf16":
        cb = jnp.bfloat16
        b1, mb, b3 = b1.astype(cb), mb.astype(cb), b3.astype(cb)
        x = x.astype(cb)
        kw = dict(preferred_element_type=jnp.float32)
    elif mode == "bf16c":
        # centered bf16: exact unit DC gain makes conv(x) =
        # conv(x - cm) + cm; S1 keeps f32 operands (the input read is
        # f32 either way) and stores bf16; S2/S3 run single-pass bf16
        cm = jnp.mean(x, axis=-2, keepdims=True)
        x = x - cm
        mb, b3 = mb.astype(jnp.bfloat16), b3.astype(jnp.bfloat16)
        kw = dict(preferred_element_type=jnp.float32)
        prec23 = jax.lax.Precision.DEFAULT
    qb = banks.get(prefix + "qb") if in_max is not None else None

    def _store(y, stage):
        # narrow materialization between stages (converts fuse into the
        # producer/consumer dots, so the HBM buffer itself is narrow)
        if mode in ("bf16", "bf16c"):
            return y.astype(jnp.bfloat16)
        if mode == "bf16store":
            return y.astype(jnp.bfloat16).astype(jnp.float32)
        if mode == "i16" and qb is not None and stage in _i16_stages():
            return _i16_store(y, qb[stage] * jnp.float32(in_max))
        return y

    n2, n1 = b1.shape[0], mb.shape[2]  # mb's k2 dim is the half-spectrum
    nd = mb.shape[4]  # output t1' count (n1/q when decimated)
    L = x.shape[-1]
    lead = x.shape[:-2]
    x = x.reshape(lead + (n2, n1, L))
    if load is not None:
        x = load(x)
    # S1: contract t2 -> (..., 2, k2, t1, L)
    y = jnp.einsum("ajc,...abL->...jcbL", b1, x, precision=precision, **kw)
    y = _store(y, 0)
    # S2: per-k2 2x2-block n1 matmul -> (..., 2, k2, t1', L)
    y = jnp.einsum("cjbkd,...jcbL->...kcdL", mb, y, precision=prec23, **kw)
    dc_post = None
    if dc_add is not None:
        import os

        if (
            mode == "i16" and qb is not None and 1 in _i16_stages()
        ) or os.environ.get("VKRESAMPLE_DC") == "scatter":
            # inject into the DC bin so the i16 store absorbs the term
            # (only needed when the S2->S3 boundary actually quantizes;
            # otherwise keep the fused S3-epilogue form)
            y = y.at[..., 0, 0, :, :].add(n2 * dc_add)
        else:
            dc_post = dc_add
    y = _store(y, 1)
    # S3: contract (re/im, k2) -> real output in the (..., e, d, L) view
    y = jnp.einsum("kce,...kcdL->...edL", b3, y, precision=prec23, **kw)
    if dc_post is not None:
        # b3[0, 0, e] == 1/n2 for EVERY e, so the DC-bin injection is
        # exactly a broadcast add of dc_add[d, L] over the t2' groups —
        # emit it as S3's fused elementwise epilogue instead of a
        # scatter-add on the spectral intermediate: the .at[].add form
        # materializes a full layout-permuted copy of each S2 output.
        # The i16 branch above keeps the in-spectrum
        # injection so the narrow store absorbs the term.
        y = y + dc_post[..., None, :, :]
    if cm is not None and epilogue is not None:
        # exact DC add-back: conv(x) = conv(x - cm) + cm * sum(kernel)
        # (in the 4D view so the epilogue sees the finished value)
        y = y + cm[..., None, :, :] * banks[prefix + "dc0"]
        cm = None
    if epilogue is not None:
        y = epilogue(y)
    y = y.reshape(lead + (n2 * nd, L))
    if cm is not None:
        y = y + cm * banks[prefix + "dc0"]
    return y


def conv_apply_lanes(
    x, banks: dict, prefix: str, precision=None, in_max=None,
):
    """Staged circular convolution over axis -1 of a REAL array
    (..., n) -> (..., n)."""
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    b1 = banks[prefix + "b1"]
    mb = banks[prefix + "m"]
    b3 = banks[prefix + "b3"]
    kw = {}
    prec23 = precision
    mode = _intermediate_mode(b1)
    cm = None
    if mode == "bf16":
        cb = jnp.bfloat16
        b1, mb, b3 = b1.astype(cb), mb.astype(cb), b3.astype(cb)
        x = x.astype(cb)
        kw = dict(preferred_element_type=jnp.float32)
    elif mode == "bf16c":
        cm = jnp.mean(x, axis=-1, keepdims=True)
        x = x - cm
        mb, b3 = mb.astype(jnp.bfloat16), b3.astype(jnp.bfloat16)
        kw = dict(preferred_element_type=jnp.float32)
        prec23 = jax.lax.Precision.DEFAULT
    qb = banks.get(prefix + "qb") if in_max is not None else None

    def _store(y, stage):
        if mode in ("bf16", "bf16c"):
            return y.astype(jnp.bfloat16)
        if mode == "bf16store":
            return y.astype(jnp.bfloat16).astype(jnp.float32)
        if mode == "i16" and qb is not None and stage in _i16_stages():
            return _i16_store(y, qb[stage] * jnp.float32(in_max))
        return y

    n2, n1 = b1.shape[0], mb.shape[2]  # mb's k2 dim is the half-spectrum
    nd = mb.shape[4]  # output t1' count (n1/q when decimated)
    lead = x.shape[:-1]
    x = x.reshape(lead + (n2, n1))
    y = jnp.einsum("ajc,...ab->...jcb", b1, x, precision=precision, **kw)
    y = _store(y, 0)
    y = jnp.einsum("cjbkd,...jcb->...kcd", mb, y, precision=prec23, **kw)
    y = _store(y, 1)
    y = jnp.einsum("kce,...kcd->...ed", b3, y, precision=prec23, **kw)
    y = y.reshape(lead + (n2 * nd,))
    if cm is not None:
        # exact DC add-back: conv(x) = conv(x - cm) + cm * sum(kernel)
        y = y + cm * banks[prefix + "dc0"]
    return y


# ---------------------------------------------------------------------------
# u=2 quad-parity transform on staged convolutions
# ---------------------------------------------------------------------------


def staged_supported(plan) -> bool:
    """Staged route applies to u=2 r2c plans with even dims and usable
    Cooley-Tukey splits on both axes (any smooth size — no dense cap).
    Widths that are not 128-aligned run at a lane-padding tax (see
    x_split_prefer) with the CAS kernels' own alignment gates deciding
    Pallas vs the XLA fallback — still far ahead of the phases route
    the class previously fell to (the reference runs ANY 7-smooth size
    at full speed, vkFFT.h:4707-5189)."""
    from . import dense

    return (
        plan.r2c
        and plan.integer_upscale == 2
        and dense.r2c_rows_supported(plan)
        and plan.h % 2 == 0
        and plan.w % 2 == 0
        and split_factors(plan.h) is not None
        and split_factors(plan.w) is not None
    )


def r2c_quad_staged_banks(plan, dtype: str = "float32") -> dict:
    """Bank pytree for the staged u=2 quad transform (detect: "stx_b1"
    present).  O(n*n1) bytes and O(n log n + n*n1^2) host build — replaces
    the dense tier's O(n^2) banks and minutes of rank-1 staging.  dtype
    "float64" serves the DOUBLE mode (any size in a few MB of banks,
    where dense f64 banks cost ~1.7 GB at 4K->8K)."""
    if not staged_supported(plan):
        raise ValueError("plan not staged-executable")
    h, w = plan.h, plan.w
    cy, a0 = y_kernel(h, plan.kept_lo_y, plan.kept_hi_y)
    psi_o, chi_o, chi_e = x_kernels(w, plan.kept_lo_x)
    banks = {}
    banks.update(
        conv_banks(
            psi_o / 255.0, "stx_", dtype=dtype, prefer=x_split_prefer(n=w)
        )
    )  # /255 folded
    banks.update(conv_banks(cy, "sty_", dtype=dtype, prefer=y_split_prefer()))
    if a0 != 0.0:
        # rank-1 relocated y-Nyquist residue: Iy = outer((-1)^t, a0(-1)^s)
        # on the odd-row lattice; applied to the beta x-pass of the image.
        # Y1n contracts the image rows; the chi convs produce the odd/even
        # output-column beta rows; yc scales them into P10/P11.
        banks["st_y1n"] = (
            ((-1.0) ** np.arange(h))[:, None] / 255.0
        ).astype(dtype)
        banks["st_yc"] = np.asarray(a0, dtype)
        # correction convs see (C, r=1, w) data — bank bytes dominate
        # their cost, so prefer a small middle factor
        banks.update(conv_banks(chi_o, "stbo_", dtype=dtype, prefer=16))
        banks.update(conv_banks(chi_e, "stbe_", dtype=dtype, prefer=16))
    return banks


def staged_precision():
    """Matmul precision for the three staged stages (and the c2c,
    fractional and u >= 3 grids and the sp pencil bodies built on them):
    the three-pass bf16 algorithm (BF16_BF16_F32_X3).  On an NVIDIA H100
    (700 W) it holds <= 1 uint8 LSB against the fp64 oracle at 8K->16K,
    at u=3 -> 6144x12288 and at the c2c flagship, where a single TF32
    pass (Precision.HIGH on the GPU) reaches maxdiff 3 / 1 / 2; it is the
    fastest of the candidates that hold the bound (PERF.md, Findings).
    VKRESAMPLE_STAGED_PRECISION=highest selects full f32 products."""
    import os

    v = os.environ.get("VKRESAMPLE_STAGED_PRECISION", "").lower()
    return (
        jax.lax.Precision.HIGHEST
        if v == "highest"
        else jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    )


def _quad_variant():
    """Composition variant for the staged quad transform (trace-time env,
    for A/B of how the two y convs and the colsum compose):
      ""        — two independent y convs (baseline)
      "batchy"  — ONE y conv over the two planes stacked on a leading dim
      "f32y"    — y convs read the un-quantized f32 planes (skip the
                  dequant roundtrip; stores still feed the CAS planes)
      "barrier" — optimization_barrier between the stored planes and the
                  y convs (pins fusion boundaries)
      "qbar"    — optimization_barrier around ONLY the x-Nyquist colsum q
      "qint"    — no-op (the int32 q is the default)
      "qf32"    — the f32 colsum q instead of the int32 one
    Variants combine comma-separated (e.g. "batchy,f32y")."""
    import os

    return set(
        v for v in os.environ.get("VKRESAMPLE_STAGED_VARIANT", "").split(",")
        if v
    )


def ynyq_dc_or_post(yc, n1: int, nd: int, qd: int, h_out: int, acc):
    """Rank-1 relocated-y-Nyquist injection factors — the ONE place the
    even/odd-n1 parity rule lives (shared by r2c_quad_staged,
    r2c_grid_staged, and the sp pencil bodies in parallel/distributed).

    Returns (dc_factor, post_factor), exactly one non-None; the caller
    multiplies by the chi-convolved correction plane t.  Even n1
    (= qd*nd): the output-row sign (-1)^(qd*(d + nd*t2')) collapses to
    (-1)^(qd*d), so the correction injects into the DC bin of the SMALL
    spectral intermediate and S3's epilogue absorbs it.  Odd n1: the
    sign depends on the outer row index, so it must be added post-hoc
    over the h_out output rows."""
    if n1 % 2 == 0:
        dsign = jnp.asarray((-1.0) ** (qd * np.arange(nd)), acc)[:, None]
        return yc * dsign, None
    rsign = jnp.asarray((-1.0) ** (qd * np.arange(h_out)), acc)[:, None]
    return None, yc * rsign


def r2c_quad_staged(x_raw, banks: dict, precision, store=None, load=None):
    """Quad-parity u=2 transform on staged circulant convolutions.
    Same contract as dense.r2c_quad: x_raw holds RAW uint8 pixel values
    (..., C, h, w); returns the four pre-CAS parity planes (stored when a
    codec is given).  See dense.r2c_quad for the parity algebra; only the
    two hot matmuls are replaced by staged convolutions."""
    variant = _quad_variant()
    w = x_raw.shape[-1]
    h = x_raw.shape[-2]
    acc = banks["stx_b1"].dtype  # f32, or f64 for the DOUBLE mode
    xf = x_raw.astype(acc)
    # P01 = x (x) psi_o: staged conv along lanes (/255 folded in).
    # in_max feeds only the experimental i16 intermediate codec: the
    # lanes input is RAW u8 (<= 255).
    P01 = conv_apply_lanes(xf, banks, "stx_", precision, in_max=255.0)
    # P00 = x/255 - rank-1 x-Nyquist correction (exact samples).  The
    # colsum q runs in int32 on the RAW u8 image (exact: w*255 << 2^31),
    # so the full-image reduction does not share the f32 xf operand with
    # the x conv (XLA can entangle the two in one fusion).  "qf32"
    # selects the f32 form for A/B.
    signs_np = (-1.0) ** np.arange(w)
    signs = jnp.asarray(signs_np, acc)
    if x_raw.dtype == jnp.uint8 and "qf32" not in variant:
        isign = jnp.asarray(
            np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
        )
        q = jnp.sum(
            x_raw.astype(jnp.int32) * isign, axis=-1, keepdims=True
        ).astype(acc)
    else:
        q = jnp.sum(xf * signs, axis=-1, keepdims=True)
    if "qbar" in variant:
        q = jax.lax.optimization_barrier(q)
    P00 = xf * jnp.asarray(1.0 / 255.0, acc) - (signs * q) * jnp.asarray(
        1.0 / (255.0 * w), acc
    )
    # rank-1 y-Nyquist correction rows (odd output rows only)
    t2e = t2o = None
    if "st_y1n" in banks:
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jnp.einsum(
            "...hw,hr->...rw", xf, banks["st_y1n"],
            precision=jax.lax.Precision.HIGHEST,
        )
        if "qbar" in variant:
            # same decoupling as q: tcorr is the other full-image
            # reduction sharing xf with the x conv
            tcorr = jax.lax.optimization_barrier(tcorr)
        t2o = conv_apply_lanes(tcorr, banks, "stbo_", precision)
        t2e = conv_apply_lanes(tcorr, banks, "stbe_", precision)
    yload = None
    if store is None:
        P00s, P01s = P00, P01
        P00m, P01m = P00, P01
    else:
        P00s, P01s = store(P00), store(P01)
        if "barrier" in variant:
            P00s, P01s = jax.lax.optimization_barrier((P00s, P01s))
        if "f32y" in variant:
            P00m, P01m = P00, P01
        elif "dqearly" in variant or "batchy" in variant:
            # early decode: the y convs read full-size dequantized
            # planes ("dqearly" decodes before the conv, for A/B;
            # "batchy" stacks the planes before the conv)
            P00m, P01m = load(P00s), load(P01s)
        else:
            # defer the Q2.14 decode into conv_apply_rows, after its
            # row-split reshape (bit-exact; see conv_apply_rows)
            P00m, P01m = P00s, P01s
            yload = load
    # y conv over rows, one per even-row plane.  The rank-1 y-Nyquist
    # correction Iy_odd[t, s] = yc*(-1)^(s-t) (Y1n carries (-1)^t) rides
    # the shared even/odd-n1 injection rule (ynyq_dc_or_post): DC-bin
    # injection fuses the i16 store into S3's epilogue instead of paying
    # a full-size post-add pass.
    n1 = banks["sty_m"].shape[2]
    dc_e = dc_o = None
    post = None
    if t2e is not None:
        dcf, post = ynyq_dc_or_post(banks["st_yc"], n1, n1, 1, h, acc)
        if dcf is not None:
            dc_e, dc_o = dcf * t2e, dcf * t2o
    if "batchy" in variant:
        Pst = jnp.stack([P00m, P01m])
        dc = None
        if dc_e is not None:
            dc = jnp.stack(
                [jnp.broadcast_to(dc_e, P00m.shape[:-2] + dc_e.shape[-2:]),
                 jnp.broadcast_to(dc_o, P01m.shape[:-2] + dc_o.shape[-2:])]
            )
        # in_max 2.0: the y conv consumes normalized [0,1] planes plus
        # Gibbs overshoot (~1.1 typical; the i16 store clips beyond)
        Pyt = conv_apply_rows(
            Pst, banks, "sty_", precision, dc_add=dc, in_max=2.0
        )
        P10, P11 = Pyt[0], Pyt[1]
    else:
        P10 = conv_apply_rows(
            P00m, banks, "sty_", precision, dc_add=dc_e, in_max=2.0,
            load=yload,
        )
        P11 = conv_apply_rows(
            P01m, banks, "sty_", precision, dc_add=dc_o, in_max=2.0,
            load=yload,
        )
    if post is not None:
        P10 = P10 + post * t2e
        P11 = P11 + post * t2o
    if store is None:
        return P00s, P01s, P10, P11
    return P00s, P01s, store(P10), store(P11)


# ---------------------------------------------------------------------------
# u-generic grid-parity transform (u >= 2): u^2 phase planes
# ---------------------------------------------------------------------------
#
# The quad route above is the u=2 member of a family: for ANY integer
# factor u the composed zero-band upscale restricted to output lattice
# (u*t + ry, u*s + rx) is a pair of real circular convolutions per phase
# (phase_y_kernel / phase_x_kernels — the fractional offsets ry/u, rx/u
# ride inside the kernels), with the same two exactness gifts:
#   - ry = 0 is the identity y roundtrip (all y bins kept on integer-u
#     plans), so the u x-pass planes are computed once and reused by
#     every y phase;
#   - rx = 0 is exact samples + the rank-1 x-Nyquist correction.
# The relocated y-Nyquist leaves a rank-1 imaginary residue a0_ry*(-1)^d
# at EVERY phase offset, handled by the same Y1n colsum + chi convs + DC
# bin injection as the quad route.  This is the any-size >8K engine for
# u >= 3 frames, which previously fell to the ~3x slower phases route
# (reference bar: any-size multi-upload FFTs, vkFFT.h:4733-4771).


def _exact_fraction(plan):
    """(p, q) of the plan's upscale as an exact rational derived from
    the INTEGER geometry: H/h == W/w reduced.  None for integer factors
    (q == 1) or mismatched axis ratios.

    The float u only ever enters the plan through the truncated output
    dims and the C-float band edges (VkResample.cpp:1491-1502) — both
    already frozen as integers on the plan — so the route is exact for
    whatever rational the GEOMETRY realizes, dyadic or not: -u 1.5 on
    any even frame gives 3/2, and -u 1.3333334 on a 9216-wide frame
    truncates to 12288 = w*4/3 and gives 4/3 (a float32 just above p/q
    truncates to exactly p*w/q whenever q | w; a float just below, e.g.
    -u 1.3333333, lands on a non-7-smooth W and is rejected at the
    engine gate like any other non-smooth geometry).  The downstream
    keep-set conditions (frac_params / c2c_grid_params) test the plan's
    ACTUAL band integers, so a float whose band math deviates from the
    rational derivation falls through to the dense tiers.  Shared by
    frac_params (r2c) and c2c_grid_params so both accept the same
    fractional factors."""
    from fractions import Fraction

    uf = Fraction(plan.H, plan.h)
    if uf != Fraction(plan.W, plan.w) or uf.denominator == 1:
        return None
    return uf.numerator, uf.denominator


def frac_params(plan):
    """(p, q) for the FRACTIONAL staged grid route, or None.

    A fractional factor u = p/q (exact from the INTEGER geometry the
    float realizes — H/h == W/w reduced, so -u 1.5 -> 3/2 and
    -u 1.3333334 -> 4/3 on q-divisible frames; see _exact_fraction)
    runs as p^2 phase planes of size (h/q, w/q): output pixel
    (p*my + ry, p*mx + rx) is a pair of staged circulant convolutions
    sampled at stride q — the stride folds into the middle-stage bank
    (conv_banks' decimate).
    The u^2 CAS renormalization cancels the (q/p)^2 transform
    normalization exactly, as in the integer case.

    Conditions: r2c, q | h and q | w (the decimated lattices exist),
    the plan's C-float band edges match the exact rational ones (all y
    bins kept — true for any u > 1 without float truncation quirks —
    and the x band = [0, w/2) with Nyquist dropped), and splits with
    q | n1 exist on both axes."""
    from fractions import Fraction

    if not plan.r2c or plan.integer_upscale is not None:
        return None
    params = _exact_fraction(plan)
    if params is None:
        return None
    p, q = params
    if (
        plan.h % 2
        or plan.w % 2
        # all y bins kept (identity y roundtrip at ry=0) and the exact
        # x band [0, w/2): guards against C-float band-edge truncation
        # producing a different keep set than the rational derivation
        or plan.kept_lo_y + plan.kept_hi_y != plan.h
        or plan.kept_lo_x != plan.w // 2
        or plan.kept_hi_x != 0
        or split_factors(plan.h, multiple_of=q) is None
        or split_factors(plan.w, multiple_of=q) is None
    ):
        return None
    return p, q


def grid_params(plan):
    """(p, q) phase/stride pair of the staged grid route: integer u ->
    (u, 1); fractional u -> frac_params; None when unsupported."""
    from . import dense

    if (
        plan.r2c
        and plan.integer_upscale is not None
        and plan.integer_upscale >= 2
        and dense.r2c_rows_supported(plan)
        and plan.h % 2 == 0
        and plan.w % 2 == 0
        and split_factors(plan.h) is not None
        and split_factors(plan.w) is not None
    ):
        return plan.integer_upscale, 1
    return frac_params(plan)


def grid_supported(plan) -> bool:
    """u-generic staged route: integer u >= 2 (or fractional p/q, see
    frac_params) r2c plans with usable Cooley-Tukey splits (any smooth
    size — no dense cap)."""
    return grid_params(plan) is not None


def grid_u(banks: dict):
    """Integer factor of a grid bank set (None when not a grid set) —
    inferred from the static bank keys at trace time."""
    if "sgx1_b1" not in banks:
        return None
    u = 2
    while f"sgx{u}_b1" in banks:
        u += 1
    return u


def r2c_grid_staged_banks(plan, dtype: str = "float32") -> dict:
    """Bank pytree for the u-generic staged grid transform (detect:
    "sgx1_b1" present / grid_u).  O(p * n * n1) bytes total.  Fractional
    factors p/q build the same bank family with the stride-q decimation
    folded into the middle-stage banks (q inferred at trace time from
    the mb shapes, so the bank pytree stays plain arrays)."""
    params = grid_params(plan)
    if params is None:
        raise ValueError("plan not grid-staged-executable")
    p, q = params
    from fractions import Fraction

    uf = Fraction(p, q)
    h, w = plan.h, plan.w
    banks = {}
    a0s = {}
    for ry in range(1, p):
        cy, a0 = phase_y_kernel(h, plan.kept_lo_y, plan.kept_hi_y, ry, uf)
        banks.update(conv_banks(cy, f"sgy{ry}_", dtype=dtype, decimate=q))
        a0s[ry] = a0
    for rx in range(1, p):
        psi, _ = phase_x_kernels(w, plan.kept_lo_x, rx, uf)
        banks.update(
            conv_banks(
                psi / 255.0, f"sgx{rx}_", dtype=dtype, decimate=q,
                prefer=x_split_prefer(q, n=w),
            )
        )
    if any(a0 != 0.0 for a0 in a0s.values()):
        banks["sg_y1n"] = (
            ((-1.0) ** np.arange(h))[:, None] / 255.0
        ).astype(dtype)
        for ry in range(1, p):
            banks[f"sg_yc{ry}"] = np.asarray(a0s[ry], dtype)
        for rx in range(p):
            _, chi = phase_x_kernels(w, plan.kept_lo_x, rx, uf)
            # correction convs see (C, r=1, w) data — bank bytes dominate
            banks.update(
                conv_banks(
                    chi, f"sgb{rx}_", dtype=dtype,
                    prefer=16 * q, decimate=q,
                )
            )
    return banks


def r2c_grid_staged(x_raw, banks: dict, precision, store=None, load=None):
    """u-generic grid-parity transform on staged circulant convolutions.
    x_raw holds RAW uint8 pixel values (..., C, h, w); returns the p^2
    pre-CAS phase planes row-major (P[0][0], P[0][1], ..., P[p-1][p-1]),
    each (..., C, h/qd, w/qd) (stored when a codec is given; qd = 1 for
    integer factors).  Same storage contract as r2c_quad_staged /
    dense.r2c_quad.

    Fractional factors p/qd: every phase plane is the stride-qd sampling
    of its circulant convolution — the y/x convs are built decimated
    (conv_banks), the ry=0 identity planes become row subsamples, and
    the rank-1 output-side signs become (-1)^(qd*m) (constant 1 for even
    qd).  qd is inferred from the decimated mb bank shapes at trace time."""
    u = grid_u(banks)
    # stride of the output sampling lattice (1 = integer factor)
    qd = banks["sgy1_m"].shape[2] // banks["sgy1_m"].shape[4]
    variant = _quad_variant()
    w = x_raw.shape[-1]
    h = x_raw.shape[-2]
    acc = banks["sgx1_b1"].dtype
    xf = x_raw.astype(acc)
    # P[0][0] = exact samples - rank-1 x-Nyquist correction; the colsum q
    # runs in int32 on the RAW u8 image (see r2c_quad_staged: the f32
    # colsum de-additivizes the composed program).  At stride qd the
    # sample columns are x[:, qd*m] and the correction sign is
    # (-1)^(qd*m).
    signs_out = jnp.asarray((-1.0) ** (qd * np.arange(w // qd)), acc)
    if x_raw.dtype == jnp.uint8 and "qf32" not in variant:
        isign = jnp.asarray(
            np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
        )
        q = jnp.sum(
            x_raw.astype(jnp.int32) * isign, axis=-1, keepdims=True
        ).astype(acc)
    else:
        signs = jnp.asarray((-1.0) ** np.arange(w), acc)
        q = jnp.sum(xf * signs, axis=-1, keepdims=True)
    xs = xf if qd == 1 else xf[..., ::qd]
    P0 = [
        xs * jnp.asarray(1.0 / 255.0, acc)
        - (signs_out * q) * jnp.asarray(1.0 / (255.0 * w), acc)
    ]
    for rx in range(1, u):
        P0.append(conv_apply_lanes(xf, banks, f"sgx{rx}_", precision))
    # rank-1 y-Nyquist correction: one colsum, one chi conv per x phase
    tc = None
    if "sg_y1n" in banks:
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jnp.einsum(
            "...hw,hr->...rw", xf, banks["sg_y1n"],
            precision=jax.lax.Precision.HIGHEST,
        )
        tc = [
            conv_apply_lanes(tcorr, banks, f"sgb{rx}_", precision)
            for rx in range(u)
        ]
    gload = None
    if store is None:
        P0s, P0m = P0, P0
    else:
        P0s = [store(p) for p in P0]
        # decode deferred into conv_apply_rows (bit-exact; the i16
        # reshape + fused dequant replace a full-size decode pass)
        P0m, gload = P0s, load
    # ry = 0 output planes: the identity y roundtrip sampled at rows
    # qd*m — a row subsample of the (full-height) x-phase planes
    planes = (
        list(P0s) if qd == 1 else [p[..., ::qd, :] for p in P0s]
    )
    for ry in range(1, u):
        n1 = banks[f"sgy{ry}_m"].shape[2]
        nd = banks[f"sgy{ry}_m"].shape[4]
        dcf = postf = None
        if tc is not None:
            dcf, postf = ynyq_dc_or_post(
                banks[f"sg_yc{ry}"], n1, nd, qd, h // qd, acc
            )
        for rx in range(u):
            dc = dcf * tc[rx] if dcf is not None else None
            P = conv_apply_rows(
                P0m[rx], banks, f"sgy{ry}_", precision, dc_add=dc,
                load=gload,
            )
            if postf is not None:
                P = P + postf * tc[rx]
            planes.append(P if store is None else store(P))
    return tuple(planes)


# ---------------------------------------------------------------------------
# c2c staged grid transform: complex phase planes via rank-1 Nyquist algebra
# ---------------------------------------------------------------------------
#
# The c2c mode's composed roundtrip per axis has the SAME circulant
# structure as the r2c y axis (phase_y_kernel applies verbatim to both
# axes — there is no Hermitian half-spectrum packing), and the c2c band
# keeps every source bin on both axes, so the complex residue is exactly
# the rank-1 relocated-Nyquist tone: per phase r the axis map is
#
#   A_r = C_r + i * a_r * s s^T      (C_r real circulant, s[t] = (-1)^t)
#
# Composing two axes on the REAL input image X (the c2c pipeline feeds a
# real image through complex transforms, VkResample.cpp:527-545):
#
#   out = A_y X A_x^T
#   re  = C_y X C_x^T - ay*ax*(s_y^T X s_x) * sYo sXo^T
#   im  = ax * (C_y (X s_x)) sXo^T + ay * sYo (C_x (X^T s_y))^T
#
# so the imaginary part of EVERY phase plane is a sum of two rank-1
# matrices (two signed sums + two tiny vector convolutions), and CAS
# consumes the magnitude sqrt(re^2+im^2) (GLSL length(),
# VkResample.cpp:904).  Verified exact vs the fp64 oracle for integer
# AND fractional (p/q, decimated) factors.  This gives big (>DENSE_MAX)
# c2c frames the staged tier — previously they fell to the phases route
# (integer u, ~3x slower) or the big-spectrum route (fractional, which
# materializes the full H x W complex spectrum and does not survive >8K
# on one chip).  Reference bar: any-size multi-upload c2c FFTs,
# vkFFT.h:4733-4771.


def c2c_grid_params(plan):
    """(p, q) phase/stride pair of the c2c staged grid route, or None.

    Conditions mirror grid_params/frac_params, plus the c2c-specific
    keep check: ALL bins kept on BOTH axes (the zero-pad upscale keep —
    guards against C-float band-edge truncation producing a partial
    keep set, where the imaginary residue would not be rank-1)."""
    from fractions import Fraction

    if plan.r2c:
        return None
    if plan.integer_upscale is not None:
        if plan.integer_upscale < 2:
            return None
        p, q = plan.integer_upscale, 1
    else:
        params = _exact_fraction(plan)
        if params is None:
            return None
        p, q = params
    if (
        plan.kept_lo_y + plan.kept_hi_y != plan.h
        or plan.kept_lo_x + plan.kept_hi_x != plan.w
        or plan.h % 2
        or plan.w % 2
        or split_factors(plan.h, multiple_of=q) is None
        or split_factors(plan.w, multiple_of=q) is None
    ):
        return None
    return p, q


def c2c_grid_u(banks: dict):
    """Phase count p of a c2c grid bank set (None when not one) —
    static (bank shape) at trace time."""
    if "cg_ay" not in banks:
        return None
    return banks["cg_ay"].shape[0]


def c2c_grid_staged_banks(plan, dtype: str = "float32") -> dict:
    """Bank pytree for the c2c staged grid transform (detect: "cg_ay"
    present / c2c_grid_u).  O(p * n * n1) bytes.  Both axes use
    phase_y_kernel; the x kernels fold the 1/255 u8 normalization; the
    per-phase Nyquist-tone amplitudes ship as the (p,) scalar banks
    cg_ay / cg_ax (entry 0 is exactly 0: the identity phase)."""
    from fractions import Fraction

    params = c2c_grid_params(plan)
    if params is None:
        raise ValueError("plan not c2c-grid-staged-executable")
    p, q = params
    uf = Fraction(p, q)
    banks = {}
    ay = np.zeros(p)
    ax = np.zeros(p)
    for r in range(1, p):
        cy, a0y = phase_y_kernel(
            plan.h, plan.kept_lo_y, plan.kept_hi_y, r, uf
        )
        banks.update(conv_banks(cy, f"cgy{r}_", dtype=dtype, decimate=q))
        ay[r] = a0y
        cx, a0x = phase_y_kernel(
            plan.w, plan.kept_lo_x, plan.kept_hi_x, r, uf
        )
        banks.update(
            conv_banks(
                cx / 255.0, f"cgx{r}_", dtype=dtype, decimate=q,
                prefer=x_split_prefer(q, n=plan.w),
            )
        )
        ax[r] = a0x
    banks["cg_ay"] = ay.astype(dtype)
    banks["cg_ax"] = ax.astype(dtype)
    return banks


def c2c_grid_staged(x_raw, banks: dict, precision, store=None, load=None):
    """c2c grid transform on staged circulant convolutions.  x_raw holds
    RAW uint8 pixel values (..., C, h, w); returns the p^2 pre-CAS
    MAGNITUDE phase planes row-major (P[0][0], ..., P[p-1][p-1]), each
    (..., C, h/qd, w/qd), in CAS units (the u^2 renormalization cancels
    into the 1/n-per-axis kernels exactly as in the r2c routes).  Same
    storage contract as r2c_grid_staged."""
    u = c2c_grid_u(banks)
    qd = banks["cgy1_m"].shape[2] // banks["cgy1_m"].shape[4]
    acc = banks["cgx1_b1"].dtype
    h, w = x_raw.shape[-2], x_raw.shape[-1]
    xf = x_raw.astype(acc)
    inv255 = jnp.asarray(1.0 / 255.0, acc)
    # signed sums for the rank-1 Nyquist terms: exact int32 on raw u8
    # (the f32 colsum de-additivized XLA's schedule in the r2c route —
    # same qint trick here)
    if x_raw.dtype == jnp.uint8:
        isy = jnp.asarray(
            np.where(np.arange(h) % 2 == 0, 1, -1).astype(np.int32)
        )
        isx = jnp.asarray(
            np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
        )
        xi = x_raw.astype(jnp.int32)
        qcol_i = jnp.sum(xi * isy[:, None], axis=-2, keepdims=True)
        prow_i = jnp.sum(xi * isx, axis=-1, keepdims=True)
        qcol = qcol_i.astype(acc)  # (..., C, 1, w)
        prow = prow_i.astype(acc)  # (..., C, h, 1)
        # the double sum S can reach 255*h*w/2 (> 2^31 at 4096x8192 on
        # checkerboard-heavy content) — the second reduction must leave
        # int32.  prow_i <= 255*w is f32-exact (< 2^24); the summation
        # rounding is ~2^-24 relative on a term scaled by 1/(h*w), far
        # below u8 resolution, and the tiny (h,1) reduction shares no
        # operand with the x conv (no qint scheduling hazard).
        S = jnp.sum(
            prow * jnp.asarray((-1.0) ** np.arange(h), acc)[:, None],
            axis=-2,
            keepdims=True,
        )  # (..., C, 1, 1)
    else:
        fsy = jnp.asarray((-1.0) ** np.arange(h), acc)
        fsx = jnp.asarray((-1.0) ** np.arange(w), acc)
        qcol = jnp.sum(xf * fsy[:, None], axis=-2, keepdims=True)
        prow = jnp.sum(xf * fsx, axis=-1, keepdims=True)
        S = jnp.sum(prow * fsy[:, None], axis=-2, keepdims=True)
    # x phase planes, shared across every y phase (rx = 0 is the exact
    # column identity: all w bins kept in c2c — no x-Nyquist correction)
    xs = xf if qd == 1 else xf[..., ::qd]
    A = [xs * inv255]
    for rx in range(1, u):
        A.append(conv_apply_lanes(xf, banks, f"cgx{rx}_", precision))
    # rank-1 vectors: v_rx = C_x (X^T s_y) (a 1-row x conv), w_ry =
    # C_y (X s_x) (a 1-col y conv) — tiny vs the plane convs
    V = [(qcol if qd == 1 else qcol[..., ::qd]) * inv255]
    for rx in range(1, u):
        V.append(conv_apply_lanes(qcol, banks, f"cgx{rx}_", precision))
    Wv = [(prow if qd == 1 else prow[..., ::qd, :]) * inv255]
    for ry in range(1, u):
        Wv.append(
            conv_apply_rows(prow, banks, f"cgy{ry}_", precision) * inv255
        )
    # x planes stored ONCE; the y convs decode them inside their own
    # row-split view (the dqlate deferral — see conv_apply_rows' load)
    # and the ry=0 magnitudes use the raw f32 values (raws), so neither
    # a full-size dequant pass nor a decode->re-encode roundtrip ever
    # materializes
    Pcols = A if store is None else [store(a) for a in A]
    sYo = jnp.asarray((-1.0) ** (qd * np.arange(h // qd)), acc)[:, None]
    sXo = jnp.asarray((-1.0) ** (qd * np.arange(w // qd)), acc)
    return c2c_planes_from_pencils(
        Pcols, V, Wv, S * inv255, banks, precision, sYo, sXo, qd,
        store=store, raws=A, load=load,
    )


def c2c_planes_from_pencils(
    Pcols, V, Wv, Sn, banks, precision, sYo, sXo, qd, store=None,
    raws=None, load=None,
):
    """Assemble the p^2 c2c magnitude planes from the column-pencil
    x-phase planes and rank-1 Nyquist pieces.  Shared by the
    single-device form (c2c_grid_staged) and the sp pencil form
    (parallel/distributed._sp_c2c_grid_body, which passes V and sXo
    pre-sliced to its local columns) so the re/im algebra lives in ONE
    place.

    Pcols: p x-phase planes, full rows (cols possibly sharded).  When
           `load` is given these are in STORED form (the y convs decode
           them inside their row-split view).
    V:     p rank-1 column vectors C_x (X^T s_y), (..., 1, cols).
    Wv:    p rank-1 row vectors C_y (X s_x), (..., rows_out, 1).
    Sn:    the signed double sum (s_y^T X s_x) / 255, (..., 1, 1).
    raws:  optional p RAW f32 x-phase planes (pre-codec) for the ry=0
           magnitudes — sqrt on the pre-store value differs from the
           legacy decode->magnitude->re-encode order by <= the Q2.14
           codec step (~0.008 u8 LSB), and lets the magnitude+encode
           fuse into the x convs' epilogues instead of a separate
           full-size pass.

    The ry>=1 magnitudes (re from the y convs) compute INSIDE
    conv_apply_rows' pre-flatten 4D epilogue: the rank-1 im terms and
    the Sn correction are row-broadcasts, exactly representable with
    sYo/Wv reshaped to the (n2, nd) row split — so the sqrt AND the
    storage encode ride S3's emission, and the flatten's sublane-
    transpose copy moves to the narrow stored dtype instead of f32
    reshapes plus a separate encode pass."""
    import os

    u = c2c_grid_u(banks)
    planes = []
    _enc = (lambda t: t) if store is None else store
    if os.environ.get("VKRESAMPLE_C2C_FUSE") == "0":
        # legacy A/B arm: post-codec ry=0 magnitudes, flattened ry>=1
        # magnitude + encode as a separate full-size pass
        Pf = [load(p) for p in Pcols] if load is not None else Pcols
        for ry in range(u):
            ayv = banks["cg_ay"][ry]
            for rx in range(u):
                axv = banks["cg_ax"][rx]
                if ry == 0:
                    re = Pf[rx] if qd == 1 else Pf[rx][..., ::qd, :]
                else:
                    re = conv_apply_rows(Pf[rx], banks, f"cgy{ry}_", precision)
                    if rx:
                        re = re - (ayv * axv) * Sn * (sYo * sXo)
                if ry == 0 and rx == 0:
                    P = jnp.abs(re)
                else:
                    if ry and rx:
                        im = axv * sXo * Wv[ry] + ayv * sYo * V[rx]
                    elif rx:
                        im = axv * sXo * Wv[ry]
                    else:
                        im = ayv * sYo * V[rx]
                    P = jnp.sqrt(re * re + im * im)
                planes.append(_enc(P))
        return tuple(planes)
    for ry in range(u):
        ayv = banks["cg_ay"][ry]
        if ry:
            n2 = banks[f"cgy{ry}_b1"].shape[0]
            nd = banks[f"cgy{ry}_m"].shape[4]
            sY4 = sYo.reshape(n2, nd, 1)
        for rx in range(u):
            axv = banks["cg_ax"][rx]
            if ry == 0:
                src = raws[rx] if raws is not None else Pcols[rx]
                re = src if qd == 1 else src[..., ::qd, :]
                if rx == 0:
                    # abs(re) == re: the identity plane is raw u8 * 1/255
                    P = jnp.abs(re)
                else:
                    im = axv * sXo * Wv[0]
                    P = jnp.sqrt(re * re + im * im)
                planes.append(_enc(P))
                continue

            # a_0 == 0 exactly: gate the rank-1 terms statically so the
            # identity phases don't trace dead broadcasts
            def _mag(y4, ry=ry, rx=rx, ayv=ayv, axv=axv, sY4=sY4):
                re4 = y4
                if rx:
                    re4 = re4 - (ayv * axv) * Sn[..., None] * (sY4 * sXo)
                W4 = Wv[ry].reshape(Wv[ry].shape[:-2] + sY4.shape)
                if rx:
                    im4 = axv * sXo * W4 + ayv * sY4 * V[rx][..., None, :, :]
                else:
                    im4 = ayv * sY4 * V[rx][..., None, :, :]
                return _enc(jnp.sqrt(re4 * re4 + im4 * im4))

            planes.append(
                conv_apply_rows(
                    Pcols[rx], banks, f"cgy{ry}_", precision,
                    load=load, epilogue=_mag,
                )
            )
    return tuple(planes)
