"""Single-image upscale pipeline: one jitted graph, uint8 in -> uint8 out.

The reference records [fwd FFT -> shift -> inv FFT -> sharpen] into one
command buffer per frame (/root/reference/VkResample.cpp:1249-1279); here
one jitted XLA program covers the entire pipeline — one host dispatch, no
intermediate host syncs, uint8 at both device-memory boundaries.

All plan-time specialization (sizes, zero bands, radix factorizations,
precision policy) happens in Python at trace time, mirroring how VkFFT bakes
everything into generated shader text (vkFFT.h:98-156: "everything baked
into shader text").
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Engine, Precision
from ..core.plan import UpscalePlan
from ..ops import cas as cas_ops
from ..ops import spectrum as spectrum_ops
from ..ops.cas_triton import cas_quad_planes
from ..ops.weave import weave_grid_u8, weave_quad_u8, weave_rows_u8


def _precas_xla(x: jnp.ndarray, plan: UpscalePlan) -> jnp.ndarray:
    """(..., h, w) float -> (..., H, W) float pre-CAS image in CAS units.

    XLA reference tier: jnp.fft + materialized big spectrum.
    """
    u2 = jnp.asarray(float(np.float32(plan.upscale)) ** 2, x.dtype)
    if plan.r2c:
        F = jnp.fft.rfft2(x)
        G = spectrum_ops.assemble_big_spectrum(F, plan)
        return u2 * jnp.fft.irfft2(G, s=(plan.H, plan.W))
    F = jnp.fft.fft2(x)
    G = spectrum_ops.assemble_big_spectrum(F, plan)
    # c2c CAS consumes the complex magnitude (VkResample.cpp:904)
    return u2 * jnp.abs(jnp.fft.ifft2(G))


def _upscale_core_xla(x, plan):
    """Post-CAS float core (kept for tests/ablation)."""
    return cas_ops.cas_sharpen(_precas_xla(x, plan), plan.sharpen)


def _precas(
    x: jnp.ndarray, plan: UpscalePlan, engine: Engine, banks=None
) -> jnp.ndarray:
    if engine is Engine.XLA:
        return _precas_xla(x, plan)
    if engine is Engine.MXU:
        from ..fft import mxu_pipeline

        return mxu_pipeline.upscale_precas_mxu(x, plan, banks)
    raise ValueError(f"unresolved engine {engine}")


def _cas_planes(planes, sharpen: float, u: int):
    """Per-parity CAS on u x u planes; the 2 x 2 case runs the GPU kernel
    (ops/cas_triton.py) where the program is lowered for CUDA."""
    if u == 2:
        return cas_quad_planes(planes, sharpen)
    return cas_ops.cas_parity_planes(planes, sharpen, u)


def _parity_capable(plan: UpscalePlan) -> bool:
    """Whether the plan may take a parity-plane CAS route.  DOUBLE stays
    on the woven f64 path: the parity routes store f32 / int16 planes."""
    return plan.precision is not Precision.DOUBLE


# Auto channel-serialization threshold: C * H * W output elements above
# which channels run as a device-side sequential loop instead of a
# leading batch dim, so one channel's transform working set is live at a
# time.  2e9 sits above the 3-channel 16K->32K frame (~1.6e9), so that
# frame runs batched; a 3-channel 32K output (~6.4e9) runs serial.  The
# value is unmeasured on the H100 (80 GB); chip_smoke.py prints the
# 16K->32K program's memory_analysis() against it.
CHANNEL_SERIAL_ELEMS = int(2e9)


def _channel_serial(plan: UpscalePlan, img_u8) -> bool:
    """Whether to run channels as a device-side lax.map loop (one channel's
    working set live at a time) instead of a leading batch dim.

    The reference itself serializes channels on device — VkFFTAppend loops
    coordinateFeatures re-pushing push constants per dispatch
    (/root/reference/vkFFT/vkFFT.h:7640-7646) — so huge frames never pay
    a 3x live-memory batch.  VKRESAMPLE_CHANNEL_SERIAL=1/0 overrides."""
    import os

    if img_u8.ndim < 3 or img_u8.shape[-1] <= 1:
        return False
    v = os.environ.get("VKRESAMPLE_CHANNEL_SERIAL")
    if v is not None:
        return v not in ("", "0")
    return plan.H * plan.W * img_u8.shape[-1] > CHANNEL_SERIAL_ELEMS


def _pipeline(
    img_u8: jnp.ndarray,
    banks=None,
    plan: UpscalePlan = None,
    engine: Engine = None,
    planar_out: bool = False,
    planes_out: bool = False,
):
    """(h, w, C) uint8 -> (H, W, C) uint8 (or (C, H, W) when planar_out).

    planes_out (u=2 only): return uint8 parity planes in the format
    planes_format(plan) reports — 'quad': four (C, H/2, W/2) planes
    p[row parity][col parity]; 'rows': (E, D) (C, H/2, W).  These are the
    per-parity CAS's native layouts (ops/cas.py cas_parity_planes); the
    PNG encoder interleaves inside its row loop, so the woven image never
    exists on device OR host.

    `banks` is the (optional) device-array pytree of dense DFT matrices,
    passed as a jit argument so multi-MB matrices never become HLO literal
    constants.
    """
    import os

    if _channel_serial(plan, img_u8):
        # sequential per-channel execution inside the one jitted program:
        # scan compiles the body once and reuses its buffers across
        # channels, so the live set is ONE channel's transform working
        # set plus the stacked u8 outputs
        body = functools.partial(
            _pipeline, plan=plan, engine=engine,
            planar_out=True, planes_out=planes_out,
        )

        def _one(xc):  # (..., h, w) uint8 -> squeezed per-channel outputs
            r = body(xc[..., None], banks)
            return jax.tree_util.tree_map(
                lambda p: p.reshape(p.shape[:-3] + p.shape[-2:]), r
            )

        outs = jax.lax.map(_one, jnp.moveaxis(img_u8, -1, 0))
        if planes_out or planar_out:
            # channel axis maps leading; the planar contract wants it
            # just before the two image dims ((C, H', W') single-frame,
            # (N, C, H', W') batched — identity for the former)
            return jax.tree_util.tree_map(
                lambda p: jnp.moveaxis(p, 0, -3), outs
            )
        return jnp.moveaxis(outs, 0, -1)

    cdtype = plan.precision.compute_dtype
    parity = _parity_capable(plan)
    storage = os.environ.get("VKRESAMPLE_HALF_STORAGE")

    def _store16(t):
        # -p 2 half-memory storage (DEFAULT): int16 Q2.14 fixed point.
        # Same bytes as the reference's fp16 storage (vkFFT.h:55
        # halfPrecisionMemoryOnly), ~16x finer resolution on the
        # CAS-clipped [0,1] signal (~0.008 u8 LSB); halves the CAS's
        # device-memory traffic vs f32.  XLA fuses the round/cast into
        # the matmul epilogues.  bf16 is an A/B knob (up to 4 u8 LSB).
        if plan.precision is not Precision.HALF or storage == "f32":
            return t
        if storage == "bf16":
            return t.astype(jnp.bfloat16)
        return cas_ops.to_i16_storage(t)

    # pre-CAS storage codec for the split paths: when int16 Q2.14 storage
    # is active, quantize INSIDE the transform (the y matmul reads the
    # dequantized stored planes) so the f32 planes never materialize —
    # see dense.r2c_quad's docstring.
    _i16_mode = plan.precision is Precision.HALF and storage not in (
        "f32",
        "bf16",
    )
    _codec = (
        dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
        if _i16_mode
        else {}
    )
    # big int8-only dense quad bank set (>DENSE_MAX; dense.r2c_quad_int8_banks):
    # usable only with parity-plane output and the i16 codec
    use_big_quad = (
        banks is not None
        and "xq_d1" in banks
        and "Ymat_ns" not in banks
        and planes_out
        and _i16_mode
        and _parity_route(plan) == "quad"
    )
    # woven callers can take the quad route too: CAS emits u8 parity
    # planes and ops/weave.py interleaves them.  Default: only where no
    # rows route exists (big staged banks); VKRESAMPLE_WOVEN=quad16
    # forces the quad weave, =rows forces rows.
    _we = os.environ.get("VKRESAMPLE_WOVEN", "")
    woven_quad = _we == "quad16" or (
        _we != "rows" and banks is not None and "Ymat_ns" not in banks
    )
    # staged circulant bank set (big tier default; fft/staged.py): three
    # small matmuls per axis, works with or without the i16 codec
    use_staged = (
        parity
        and banks is not None
        and "stx_b1" in banks
        and (planes_out or woven_quad)
        and _parity_route(plan) == "quad"
    )

    def _finish_grid(Pu8, u):
        if planes_out:
            return Pu8
        out = weave_grid_u8(Pu8, u)
        return out if planar_out else jnp.moveaxis(out, -3, -1)

    if (
        parity
        and planes_out
        and engine is Engine.MXU
        and (banks is None or "Ymat_ns" not in banks)
        and not use_big_quad
        and not use_staged
        and plan.r2c
        and plan.mxu_mode == "phases"
        and _parity_route(plan) == "quad"
    ):
        # beyond the dense banks (>DENSE_MAX axes, integer u=2): the phase
        # decomposition IS the parity decomposition — feed the four phase
        # planes straight to the parity CAS; neither the woven image nor
        # the big spectrum ever exists
        from ..fft.rfft2 import irfft2_phase_planes, rfft2_packed

        x = cas_ops.normalize_u8(img_u8, cdtype)
        x = jnp.moveaxis(x, -1, -3)
        keep_nyq = plan.kept_hi_x > 0
        kx = plan.w // 2 + (1 if keep_nyq else 0)
        F = rfft2_packed(x, k_cols=kx)  # trim before the y transform
        pl4 = irfft2_phase_planes(F, plan.h, plan.w, 2, keep_nyq)
        Ps = [_store16(p) for p in (pl4[0][0], pl4[0][1], pl4[1][0], pl4[1][1])]
        return _cas_planes(Ps, plan.sharpen, 2)

    if (
        parity
        and engine is Engine.MXU
        and banks is not None
        and "cg_ay" in banks
        and not plan.r2c
    ):
        # c2c tier: staged grid transform -> p^2 magnitude planes ->
        # per-parity CAS.  CAS consumes the complex magnitude
        # (VkResample.cpp:904), which the transform already emits per
        # plane via the rank-1 Nyquist algebra (fft/staged.py
        # c2c_grid_staged).
        from ..fft import staged

        x_raw = jnp.moveaxis(img_u8, -1, -3)  # (..., C, h, w)
        u = staged.c2c_grid_u(banks)
        Ps = staged.c2c_grid_staged(
            x_raw, banks, staged.staged_precision(), **_codec
        )
        if not _i16_mode:
            Ps = [_store16(p) for p in Ps]
        return _finish_grid(_cas_planes(Ps, plan.sharpen, u), u)

    if (
        parity
        and engine is Engine.MXU
        and banks is not None
        and "sgx1_b1" in banks
        and plan.r2c
    ):
        # u >= 3 / fractional big tier: u-generic grid staged transform ->
        # u^2 phase planes -> per-parity CAS (the u=2 quad route's
        # generalization).  planes_out feeds the PNG encoder's row-loop
        # weave; woven callers get the device u8 weave.
        from ..fft import staged

        x_raw = jnp.moveaxis(img_u8, -1, -3)  # (..., C, h, w)
        u = staged.grid_u(banks)
        Ps = staged.r2c_grid_staged(
            x_raw, banks, staged.staged_precision(), **_codec
        )
        if not _i16_mode:
            Ps = [_store16(p) for p in Ps]
        return _finish_grid(_cas_planes(Ps, plan.sharpen, u), u)

    if (
        parity
        and engine is Engine.MXU
        and banks is not None
        and ("Ymat_ns" in banks or use_big_quad or use_staged)
        and plan.r2c
    ):
        # row-split fast path: raw uint8 feeds the split-bf16 x matmul
        # (normalization folded into the banks); the y matmul emits the
        # non-sample rows; CAS runs per output parity.
        from ..fft import dense

        x_raw = jnp.moveaxis(img_u8, -1, -3)  # (..., C, h, w)
        prec = plan.precision.matmul_precision
        fmt = _parity_route(plan)
        if (
            fmt == "quad"
            and ("alpha_odd_hi" in banks or use_big_quad or use_staged)
            and (planes_out or (woven_quad and not use_big_quad))
        ):
            # quad-parity: x matmul only computes ODD output columns (even
            # columns are exact samples + a rank-1 correction); CAS runs
            # per (row, col) output parity on four half-width planes — no
            # interleave anywhere on device
            if use_staged:
                from ..fft import staged

                Ps = staged.r2c_quad_staged(
                    x_raw, banks, staged.staged_precision(), **_codec
                )
            else:
                Ps = dense.r2c_quad(x_raw, banks, prec, **_codec)
            if not _i16_mode:
                Ps = [_store16(p) for p in Ps]
            Pu8 = _cas_planes(Ps, plan.sharpen, 2)
            if planes_out:
                return Pu8
            out = weave_quad_u8(*Pu8)
            return out if planar_out else jnp.moveaxis(out, -3, -1)

        U, O = dense.r2c_rows(x_raw, banks, prec, **_codec)
        if not _i16_mode:
            U, O = _store16(U), _store16(O)
        if fmt is not None:
            # per-parity CAS on the (even, odd) output-row planes: no
            # woven pre-CAS image, no device-side row weave
            E, D = cas_ops.cas_parity_planes([U, O], plan.sharpen, 2, 1)
            if planes_out:
                return E, D
            out = weave_rows_u8(E, D)
        else:
            v = dense.weave_rows(
                cas_ops.clip_unit(U), cas_ops.clip_unit(O), plan.integer_upscale
            )
            out = cas_ops.quantize_u8(cas_ops.cas_sharpen(v, plan.sharpen))
        if planes_out:
            o4 = out.reshape(
                out.shape[:-2] + (out.shape[-2] // 2, 2, out.shape[-1])
            )
            return o4[..., 0, :], o4[..., 1, :]
        return out if planar_out else jnp.moveaxis(out, -3, -1)

    x = cas_ops.normalize_u8(img_u8, cdtype)  # (..., h, w, C)
    x = jnp.moveaxis(x, -1, -3)  # planar per-channel, like the reference
    v = _precas(x, plan, engine, banks)
    out = cas_ops.quantize_u8(cas_ops.cas_sharpen(v, plan.sharpen))
    if planes_out:
        o4 = out.reshape(
            out.shape[:-2] + (out.shape[-2] // 2, 2, out.shape[-1])
        )
        return o4[..., 0, :], o4[..., 1, :]
    return out if planar_out else jnp.moveaxis(out, -3, -1)


def make_device_banks(
    plan: UpscalePlan, engine: Engine, device=None, planes: bool = True
):
    """Device-resident dense bank pytree for MXU plans (None otherwise).
    planes: whether the caller consumes parity-plane output — gates the
    big int8-only bank set (see make_dense_banks)."""
    if engine is not Engine.MXU:
        return None
    import numpy as _np

    from ..fft import mxu_pipeline

    banks = mxu_pipeline.make_dense_banks(
        plan, _np.dtype(plan.precision.compute_dtype).name, planes=planes
    )
    if banks is None:
        return None
    if device is None:
        return jax.device_put(banks)
    return jax.device_put(banks, device)


def _parity_route(plan: UpscalePlan):
    """Which parity formulation the u=2 fast path uses (geometry/env only;
    callers gate on engine/banks): 'quad' (rows AND columns split — four
    planes), 'rows' (two planes), or None."""
    import os

    if plan.integer_upscale != 2 or os.environ.get("VKRESAMPLE_NO_PARITY"):
        return None
    from ..fft.mxu_pipeline import DENSE_MAX

    # in the small dense tier quad serves 128-aligned widths and the rows
    # route the rest; ABOVE the dense cap no rows route exists, so quad
    # serves every even width (the staged tier, see
    # staged.staged_supported).  Which route is faster for non-aligned
    # dense widths is unmeasured on the H100.
    if (
        (
            plan.w % 128 == 0
            or max(plan.h, plan.w, plan.H, plan.W) > DENSE_MAX
        )
        and os.environ.get("VKRESAMPLE_HALF_STORAGE") != "bf16"
    ):
        return "quad"
    return "rows"


def parity_planes_supported(plan: UpscalePlan) -> bool:
    """True when the plan runs a per-parity CAS route whose native
    device output is uint8 parity planes that the PNG encoder weaves for
    free (see planes_format for which layout)."""
    from ..fft import dense
    from ..fft.mxu_pipeline import DENSE_MAX, big_grid_selected

    if not (
        _parity_capable(plan)
        and plan.resolve_engine() is Engine.MXU
    ):
        return False
    if big_grid_selected(plan):
        # grid big tiers (r2c u >= 3 / fractional, and c2c): u^2
        # grid-parity planes
        return True
    if not plan.r2c:
        return False
    if _parity_route(plan) is None:
        return False
    if (
        dense.r2c_rows_supported(plan)
        and max(plan.h, plan.w, plan.H, plan.W) <= DENSE_MAX
    ):
        return True
    # beyond the dense banks: the phase-decomposed route supplies the quad
    # planes directly (the phases ARE the parities)
    return plan.mxu_mode == "phases" and _parity_route(plan) == "quad"


def planes_format(plan: UpscalePlan):
    """Device output layout of the planes_out pipeline: 'quad' = four
    (C, H/2, W/2) planes p[row parity][col parity]; 'rows' = (E, D)
    (C, H/2, W) planes; 'grid' = u^2 (C, H/u, W/u) planes row-major
    (ry, rx) (u >= 3 big tier); None = woven output only."""
    if not parity_planes_supported(plan):
        return None
    from ..fft.mxu_pipeline import big_grid_selected

    if big_grid_selected(plan):
        return "grid"
    return _parity_route(plan)


@functools.lru_cache(maxsize=64)
def build_upscale(
    plan: UpscalePlan,
    planar_out: bool = False,
    device_id: Optional[int] = None,
    planes_out: bool = False,
) -> Callable:
    """Compile-once plan cache: the analog of initializeVulkanFFT being
    called once per (shape, precision, upscale) and reused across frames
    (VkResample.cpp:1506-1508, reuse loop at 1627).  The dense DFT banks
    are materialized on device here (the analog of VkFFT's plan-time LUT
    upload, vkFFT.h:6157-6308) and passed per call.

    device_id selects the target device (the -d flag,
    VkResample.cpp:1828-1844): banks are committed to it so the jitted
    program and all its operands land on the same chip."""
    engine = plan.resolve_engine()
    device = None if device_id is None else jax.devices()[device_id]
    jitfn = jax.jit(
        functools.partial(
            _pipeline,
            plan=plan,
            engine=engine,
            planar_out=planar_out,
            planes_out=planes_out,
        )
    )

    if plan.precision is Precision.DOUBLE:

        def fn_x64(img, _fn=jitfn, _plan=plan, _engine=engine, _banks=[None]):
            with jax.enable_x64():
                if _banks[0] is None:
                    _banks[0] = (
                        make_device_banks(
                            _plan, _engine, device, planes=planes_out
                        ),
                    )
                return _fn(img, _banks[0][0])

        return fn_x64

    banks = make_device_banks(plan, engine, device, planes=planes_out)

    def fn(img, _fn=jitfn, _banks=banks):
        return _fn(img, _banks)

    return fn


def upscale(
    img,
    upscale: float,
    precision: Precision = Precision.SINGLE,
    sharpen: float = 0.2,
    r2c: bool = True,
    engine: Engine = Engine.AUTO,
    plan: Optional[UpscalePlan] = None,
):
    """Convenience entry: upscale one (h, w, C) uint8 image.

    Returns (H, W, C) uint8 on device (call np.asarray / block to fetch).
    """
    img = jnp.asarray(img)
    if img.dtype != jnp.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    h, w = img.shape[0], img.shape[1]
    c = img.shape[2] if img.ndim == 3 else 1
    if img.ndim == 2:
        img = img[:, :, None]
    if plan is None:
        plan = UpscalePlan(
            h=h,
            w=w,
            upscale=upscale,
            precision=precision,
            sharpen=sharpen,
            r2c=r2c,
            channels=c,
            engine=engine,
        )
    return build_upscale(plan)(img)
