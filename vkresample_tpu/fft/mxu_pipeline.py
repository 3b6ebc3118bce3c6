"""Matmul-tier (Engine.MXU) upscale core: matmul FFTs + phase-decomposed
zero-pad inverse.

This is the hot path for integer upscale factors on 7-smooth even-sized
frames (the reference's headline configuration).  The whole per-frame
pipeline is matrix contractions and elementwise ops; the big spectrum is
never materialized and zero bins are never computed — the equivalent of
VkFFT's frequency zero-padding guards (vkFFT.h:1277-1470).

Scaling contract: irfft2_phases/ifft2_phases_c2c return values already in
CAS units (the u^2 inverse-renormalization of VkResample.cpp:1615 is folded
into the source-size transforms), so CAS is applied without a pre-multiply.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.plan import UpscalePlan
from ..ops import cas as cas_ops
from .rfft2 import (
    fft2_c2c,
    ifft2_big_c2c,
    ifft2_phases_c2c,
    irfft2_big,
    irfft2_phases,
    rfft2_packed,
)


def _assemble_pair(F, plan):
    """assemble_big_spectrum over a (re, im) pair."""
    from ..ops.spectrum import assemble_big_spectrum

    return assemble_big_spectrum(F[0], plan), assemble_big_spectrum(F[1], plan)


# largest axis length the dense engine will build a DFT matrix for; bigger
# plans take the staged / grid tiers (or the mixed-radix path).  8192
# covers 4K -> 8K with <=0.5 GB of banks.  Unmeasured on the H100: the
# dense-vs-staged crossover there may sit elsewhere.
DENSE_MAX = 8192
# ...except the u=2 half-mode int8 quad bank set (VKRESAMPLE_BIG=int8),
# whose digit banks stay affordable (~250 MB at 8K->16K) — see
# dense.r2c_quad_int8_banks.  Also unmeasured on the H100.
DENSE_INT8_MAX = 16384


def big_grid_selected(plan) -> bool:
    """True when make_dense_banks will return a GRID staged bank set
    (p x p phase planes).  NOTE the size semantics differ by mode:
    r2c grid selection is big-tier only (>DENSE_MAX, integer u >= 3 or
    fractional p/q via staged.frac_params — below the cap the dense
    tiers win); c2c grid selection is SIZE-INDEPENDENT (delegates to
    c2c_grid_selected: the dense c2c alternative has no parity
    decomposition, so the grid form is the default at every size).
    Without the grid tiers these frames fall to the ~3x slower phases
    route (integer u) or the big-spectrum route (fractional — which
    materializes the full H x W complex spectrum and does not survive
    >8K on one chip).  Reference bar: any size at full speed via
    multi-upload FFTs, vkFFT.h:4733-4771."""
    import os

    from ..core.config import Precision
    from . import staged

    if not plan.r2c:
        # c2c grid routing is size-independent (see c2c_grid_selected)
        return c2c_grid_selected(plan)
    if (
        plan.precision is Precision.DOUBLE
        or os.environ.get("VKRESAMPLE_NO_PARITY")
        or os.environ.get("VKRESAMPLE_HALF_STORAGE") == "bf16"
        or os.environ.get("VKRESAMPLE_BIG", "staged") != "staged"
    ):
        return False
    if max(plan.h, plan.w, plan.H, plan.W) <= DENSE_MAX:
        # small fractional r2c normally takes the dense big-spectrum
        # mode; VKRESAMPLE_FRAC=grid opts the grid form in for A/B (the
        # dense alternative materializes the full H x W complex
        # spectrum, so the grid may win here even below the cap —
        # unmeasured, hence opt-in)
        return (
            os.environ.get("VKRESAMPLE_FRAC") == "grid"
            and plan.integer_upscale is None
            and staged.frac_params(plan) is not None
        )
    return (
        (plan.integer_upscale is not None and plan.integer_upscale >= 3)
        or (
            plan.integer_upscale is None
            and staged.frac_params(plan) is not None
        )
    ) and staged.grid_supported(plan)


def c2c_grid_selected(plan) -> bool:
    """c2c plans route the staged GRID form at EVERY size when eligible
    (not just >DENSE_MAX): the dense alternative is the 5-matmul complex
    chain + full-array CAS with no parity decomposition (~3x the r2c
    flagship time at the same shape), while the grid form gives c2c the
    parity-plane + fused-CAS structure of the r2c fast path.
    VKRESAMPLE_C2C=dense restores the dense chain for A/B."""
    import os

    from ..core.config import Precision
    from . import staged

    if (
        plan.r2c
        or plan.precision is Precision.DOUBLE
        or os.environ.get("VKRESAMPLE_NO_PARITY")
        or os.environ.get("VKRESAMPLE_HALF_STORAGE") == "bf16"
        or os.environ.get("VKRESAMPLE_BIG", "staged") != "staged"
        or os.environ.get("VKRESAMPLE_C2C", "staged") == "dense"
    ):
        return False
    params = staged.c2c_grid_params(plan)
    if params is None:
        return False
    # below the dense cap, a large phase count p means p^2 small planes
    # and 2p bank sets — the dense chain stays the better route for
    # exotic fractions (e.g. -u 2.75 = 11/4 -> 121 planes); above the
    # cap the grid is the only tier that survives, any p
    if max(plan.h, plan.w, plan.H, plan.W) <= DENSE_MAX and params[0] > 4:
        return False
    return True


def make_dense_banks(
    plan: UpscalePlan, dtype: str = "float32", planes: bool = False
):
    """Numpy bank pytree for the dense chain, or None when the plan routes
    to the mixed-radix path.  Callers jax.device_put the result and pass it
    as a jit ARGUMENT (multi-MB HLO literal constants choke compilation).

    Beyond DENSE_MAX, eligible u=2 plans get the STAGED circulant bank
    set (detect: "stx_b1" present — fft/staged.py: three small matmuls
    per axis, O(n*n1) bank bytes, any composite size) for BOTH plane
    consumers (planes=True, the PNG path) and woven callers (the quad
    planes + u16-packed column weave, ops/weave.py).  VKRESAMPLE_BIG=
    int8 falls back to the int8 dense quad tier (O(n^2) banks,
    planes-only, capped at DENSE_INT8_MAX) for A/B."""
    import functools
    import os

    from ..core.bankcache import get_or_build
    from ..core.config import Precision
    from . import dense, staged

    def _cached(tag, build, *args, built_dtype=None):
        # big-geometry bank staging is seconds to minutes of host numpy;
        # the disk cache (core/bankcache.py) makes the second CLI run at
        # the same geometry skip it.  built_dtype keys
        # entries by the dtype the builder ACTUALLY produces (the staged
        # builders ignore the caller dtype), so one bank set never caches
        # under several keys.
        return get_or_build(
            tag, plan, built_dtype or dtype, functools.partial(build, *args)
        )

    if (
        plan.precision is Precision.DOUBLE
        and os.environ.get("VKRESAMPLE_BIG", "staged") == "staged"
    ):
        # DOUBLE runs the staged circulant routes at EVERY size: the dense
        # f64 banks cost O(n^2) bytes (~1.7 GB at 4K->8K) where staged
        # banks are a few MB, and f64 rides the staged matmuls natively
        # (consumed by the woven upscale_precas_mxu path — the DOUBLE
        # pipeline stays on XLA CAS).  u=2 r2c takes the quad form; u>=3
        # r2c, fractional, and c2c take the grid forms (without which
        # big DOUBLE frames fall to the f64 phases/big-spectrum routes,
        # which do not survive >8K).
        if plan.r2c and staged.staged_supported(plan):
            return _cached(
                "staged64", staged.r2c_quad_staged_banks, plan, "float64",
                built_dtype="float64",
            )
        if plan.r2c and staged.grid_supported(plan):
            return _cached(
                "grid64", staged.r2c_grid_staged_banks, plan, "float64",
                built_dtype="float64",
            )
        if not plan.r2c and staged.c2c_grid_params(plan) is not None:
            return _cached(
                "c2cgrid64", staged.c2c_grid_staged_banks, plan, "float64",
                built_dtype="float64",
            )
    if c2c_grid_selected(plan):
        # c2c tier at EVERY size: complex grid staged banks (detect:
        # "cg_ay" present — fft/staged.py c2c_grid_staged).  The dense
        # c2c chain (5 complex matmuls + full-array CAS) stays behind
        # VKRESAMPLE_C2C=dense for A/B.
        return _cached(
            "c2cgrid", staged.c2c_grid_staged_banks, plan,
            built_dtype="float32",
        )
    if plan.r2c and big_grid_selected(plan):
        # u >= 3 / fractional grid tier: u-generic grid staged banks
        # (detect: "sgx1_b1" present — fft/staged.py r2c_grid_staged).
        # Size-gating lives in big_grid_selected (big-tier by default;
        # VKRESAMPLE_FRAC=grid opts small fractional frames in for A/B).
        return _cached(
            "grid", staged.r2c_grid_staged_banks, plan,
            built_dtype="float32",
        )
    if max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        quad_geom = (
            plan.r2c
            and plan.integer_upscale == 2
            and not os.environ.get("VKRESAMPLE_NO_PARITY")
            and os.environ.get("VKRESAMPLE_HALF_STORAGE") != "bf16"
            and dense.r2c_rows_supported(plan)
        )
        if (
            quad_geom
            and plan.precision is not Precision.DOUBLE
            and os.environ.get("VKRESAMPLE_BIG", "staged") == "staged"
            and staged.staged_supported(plan)
        ):
            # staged banks serve BOTH consumers: parity planes (PNG path)
            # and woven output (library API — quad planes + the u16-packed
            # column weave, ops/weave.py)
            return _cached(
                "staged", staged.r2c_quad_staged_banks, plan,
                built_dtype="float32",
            )
        if (
            planes
            and quad_geom
            and plan.w % 128 == 0  # int8 digit banks keep the hard gate
            and max(plan.h, plan.w, plan.H, plan.W) <= DENSE_INT8_MAX
            and dense._int8_banks_wanted(plan)
        ):
            return _cached(
                "bigint8", dense.r2c_quad_int8_banks, plan, dtype
            )
        return None
    if plan.r2c:
        if dense.r2c_rows_supported(plan):
            return _cached("rows", dense.r2c_rows_banks, plan, dtype)
        return _cached("chain", dense.r2c_chain_banks, plan, dtype)
    return _cached("c2c", dense.c2c_chain_banks, plan, dtype)


def upscale_precas_mxu(
    x: jnp.ndarray, plan: UpscalePlan, banks=None
) -> jnp.ndarray:
    """(..., h, w) float -> (..., H, W) float pre-CAS image in CAS units
    (real values for r2c, complex magnitude for c2c).

    banks: device bank pytree from make_dense_banks (None builds numpy
    banks inline — convenient for tests, bad for remote-compile payload).
    """
    from . import dense

    if banks is not None and "cg_ay" in banks:
        # c2c staged grid banks (big tier): p^2 magnitude planes woven
        # back to the full frame — the correctness/validate path; the
        # perf path consumes the planes directly (planes_out)
        import jax as _jax

        from . import staged

        Ps = staged.c2c_grid_staged(
            x * 255.0, banks, _jax.lax.Precision.HIGHEST
        )
        u = staged.c2c_grid_u(banks)
        h, w = Ps[0].shape[-2], Ps[0].shape[-1]
        lead = Ps[0].shape[:-2]
        g = jnp.stack(Ps, axis=-3).reshape(lead + (u, u, h, w))
        g = jnp.moveaxis(jnp.moveaxis(g, -4, -2), -4, -1)
        return g.reshape(lead + (u * h, u * w))
    if banks is not None and ("stx_b1" in banks or "sgx1_b1" in banks):
        # staged circulant banks (big tier): compute the parity/phase
        # planes and weave — the correctness/woven path; the perf path
        # consumes the planes directly (planes_out)
        import jax as _jax

        from . import staged

        if "stx_b1" in banks:
            Ps = staged.r2c_quad_staged(
                x * 255.0, banks, _jax.lax.Precision.HIGHEST
            )
            u = 2
        else:
            Ps = staged.r2c_grid_staged(
                x * 255.0, banks, _jax.lax.Precision.HIGHEST
            )
            u = staged.grid_u(banks)
        h, w = Ps[0].shape[-2], Ps[0].shape[-1]
        lead = Ps[0].shape[:-2]
        g = jnp.stack(Ps, axis=-3).reshape(lead + (u, u, h, w))
        g = jnp.moveaxis(jnp.moveaxis(g, -4, -2), -4, -1)  # (..., h, u, w, u)
        return g.reshape(lead + (u * h, u * w))
    if max(plan.h, plan.w, plan.H, plan.W) <= DENSE_MAX:
        prec = plan.precision.matmul_precision
        if banks is None:
            banks = make_dense_banks(plan, x.dtype.name)
        if plan.r2c:
            if "Ymat_ns" in banks:  # row-split fast path (integer u)
                # r2c_rows expects raw 0..255 values (normalization folded
                # into the banks); x arrives normalized here
                U, O = dense.r2c_rows(x * 255.0, banks, prec)
                return dense.weave_rows(U, O, plan.integer_upscale)
            return dense.r2c_chain(x, banks, prec)
        return dense.c2c_chain(x, banks, prec)
    return _precas_mixed_radix(x, plan)


def upscale_core_mxu(
    x: jnp.ndarray, plan: UpscalePlan, banks=None
) -> jnp.ndarray:
    """(..., h, w) float -> (..., H, W) float (post-CAS, pre-quantization)."""
    return cas_ops.cas_sharpen(
        upscale_precas_mxu(x, plan, banks), plan.sharpen
    )


def _precas_mixed_radix(x: jnp.ndarray, plan: UpscalePlan) -> jnp.ndarray:
    mode = plan.mxu_mode
    if mode is None:
        raise ValueError(
            f"plan not MXU-executable (u={plan.upscale}, "
            f"{plan.h}x{plan.w} -> {plan.H}x{plan.W}); use Engine.XLA"
        )
    if mode == "big" and max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX:
        # the big-spectrum mode materializes the full H x W complex
        # spectrum and does not fit beyond the dense cap; every big
        # fractional geometry with a route is
        # claimed by the staged grid tier upstream (H/h == W/w == p/q
        # with q | dims and the C-float band edges matching the rational
        # keep set, fft/staged.py frac_params) — reaching here means the
        # plan has no viable route, so fail clean instead of compiling a
        # program that exhausts the chip
        raise ValueError(
            f"fractional upscale {plan.upscale} at {plan.h}x{plan.w} -> "
            f"{plan.H}x{plan.W} exceeds the dense-spectrum tier "
            f"({DENSE_MAX}) and does not match the staged fractional "
            "grid (needs H/h == W/w == p/q with q dividing both input "
            "dims, width/q a multiple of 128, and full-band keep); "
            "choose an upscale whose output dims are exact rational "
            "multiples, or an integer factor"
        )
    u2 = jnp.asarray(float(np.float32(plan.upscale)) ** 2, x.dtype)

    if plan.r2c:
        F = rfft2_packed(x)
        if mode == "phases":
            # phase inverse folds the u^2 renormalization in — no prescale
            out = irfft2_phases(
                F, plan.h, plan.w, plan.integer_upscale, plan.kept_hi_x > 0
            )
        else:  # fractional factor: big spectrum materialized, matmul FFTs
            G = _assemble_pair(F, plan)
            out = u2 * irfft2_big(G, plan.H, plan.W)
        return out

    zeros = jnp.zeros_like(x)
    F = fft2_c2c((x, zeros))
    if mode == "phases":
        yr, yi = ifft2_phases_c2c(F, plan.h, plan.w, plan.integer_upscale)
    else:
        G = _assemble_pair(F, plan)
        yr, yi = ifft2_big_c2c(G)
        yr, yi = u2 * yr, u2 * yi
    # c2c CAS consumes the complex magnitude (VkResample.cpp:904)
    return jnp.sqrt(yr * yr + yi * yi)
