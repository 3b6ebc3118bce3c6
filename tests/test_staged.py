"""Staged circulant-convolution engine vs the dense banks and the oracle.

The staged route factors each axis's circulant contraction into three
small matmuls (fft/staged.py); these tests pin its algebra to the dense
tier's O(n^2) matrices (which are themselves oracle-pinned)."""
import jax
import numpy as np
import pytest
from jax import numpy as jnp

from vkresample_tpu.core.config import Engine, Precision
from vkresample_tpu.core.plan import UpscalePlan
from vkresample_tpu.fft import dense, staged
from vkresample_tpu.ops import cas as cas_ops
from vkresample_tpu.oracle import numpy_ref as oracle

HIGHEST = jax.lax.Precision.HIGHEST


def _circulant_ref(kernel, x):
    """out[s] = sum_t kernel[(s-t) mod n] x[t] over the last axis."""
    return np.real(
        np.fft.ifft(np.fft.fft(kernel) * np.fft.fft(x, axis=-1), axis=-1)
    )


def test_staged_conv_matches_circulant_lanes_and_rows():
    rng = np.random.default_rng(0)
    n = 24
    kernel = rng.standard_normal(n)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.conv_banks(kernel, "t_", n1=4).items()
    }
    x = rng.standard_normal((3, 5, n))
    out = staged.conv_apply_lanes(jnp.asarray(x), banks, "t_", HIGHEST)
    assert np.abs(np.asarray(out) - _circulant_ref(kernel, x)).max() < 1e-4
    # rows: same conv along axis -2
    xr = np.moveaxis(x, -1, -2)  # (3, n, 5)
    out = staged.conv_apply_rows(jnp.asarray(xr), banks, "t_", HIGHEST)
    want = np.moveaxis(_circulant_ref(kernel, x), -1, -2)
    assert np.abs(np.asarray(out) - want).max() < 1e-4


def test_kernels_match_dense_chain_banks():
    """psi_o/chi kernels and the y kernel reproduce the dense tier's
    alpha/beta/Ymat_ns columns exactly (same band geometry)."""
    plan = UpscalePlan(
        h=64, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    h, w, H, W = plan.h, plan.w, plan.H, plan.W
    alpha, beta, Ry, Y1, Y2 = dense._r2c_chain_banks(
        h, w, H, W,
        plan.kept_lo_y, plan.kept_hi_y, plan.kept_lo_x, False, "float64",
    )
    psi_o, chi_o, chi_e = staged.x_kernels(w, plan.kept_lo_x)
    # alpha_odd[i, s] = psi_o[(s - i) mod w]
    i, s = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    assert np.abs(alpha[:, 1::2] - psi_o[(s - i) % w]).max() < 1e-12
    assert np.abs(beta[:, 1::2] - chi_o[(s - i) % w]).max() < 1e-12
    assert np.abs(beta[:, 0::2] - chi_e[(s - i) % w]).max() < 1e-12
    # y kernel: Ymat_ns main rows are the odd-row circulant
    Ymat = np.concatenate([Ry, Y2], axis=0)
    Ymat_ns = Ymat.reshape(-1, h, 2)[:h, :, 1]  # (t_in, s_out) odd rows
    cy, a0 = staged.y_kernel(h, plan.kept_lo_y, plan.kept_hi_y)
    t, so = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    assert np.abs(Ymat_ns - cy[(so - t) % h]).max() < 1e-12
    # rank-1 imaginary residue matches the dense Y1 (x) Y2 factorization
    iy = np.outer(Y1[:, 0], Y2[0]) if Y1.shape[1] else np.zeros((h, H))
    iy_odd = iy[:, 1::2]
    want = a0 * (-1.0) ** (so - t)
    assert np.abs(iy_odd - want).max() < 1e-12


def test_staged_quad_matches_oracle():
    plan = UpscalePlan(
        h=64, w=256, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    assert staged.staged_supported(plan)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 256, 3), np.uint8)
    banks = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    Ps = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
    # reassemble the woven pre-CAS image from the parity planes
    got = np.zeros((3, 128, 512))
    got[:, 0::2, 0::2] = np.asarray(Ps[0], np.float64) / 16384.0
    got[:, 0::2, 1::2] = np.asarray(Ps[1], np.float64) / 16384.0
    got[:, 1::2, 0::2] = np.asarray(Ps[2], np.float64) / 16384.0
    got[:, 1::2, 1::2] = np.asarray(Ps[3], np.float64) / 16384.0
    # pre-CAS oracle in CAS units: u^2 * zero-band inverse
    u2 = float(np.float32(plan.upscale)) ** 2
    want = np.empty((3, 128, 512))
    for ch in range(3):
        F = np.fft.rfft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        want[ch] = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    assert np.abs(got - want).max() < 2e-3  # well under half a u8 LSB


@pytest.mark.parametrize("h,w", [(32, 128), (96, 120)])
def test_pipeline_staged_banks_route(monkeypatch, h, w):
    """_pipeline with staged banks: parity-plane output matches the
    oracle, and the woven
    upscale_precas_mxu fallback handles staged banks too.  (96, 120)
    pins the non-128-aligned big-width class end to end: above the
    dense cap _parity_route must send any even width to quad."""
    import functools

    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    if w % 128:
        # above the (patched) dense cap the non-aligned width must still
        # route quad and build staged banks through make_dense_banks
        monkeypatch.setattr(mxu_pipeline, "DENSE_MAX", 64)
        assert up._parity_route(plan) == "quad"
        rbanks = mxu_pipeline.make_dense_banks(plan, "float32", planes=True)
        assert any(k.startswith("st_") for k in rbanks)
    banks = jax.device_put(
        {k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()}
    )
    img = np.random.default_rng(11).integers(0, 256, (h, w, 3), np.uint8)
    outs = jax.jit(
        functools.partial(
            up._pipeline, plan=plan, engine=Engine.MXU,
            planar_out=True, planes_out=True,
        )
    )(jnp.asarray(img), banks)
    got = np.zeros((3, 2 * h, 2 * w), np.uint8)
    got[:, 0::2, 0::2] = np.asarray(outs[0])
    got[:, 0::2, 1::2] = np.asarray(outs[1])
    got[:, 1::2, 0::2] = np.asarray(outs[2])
    got[:, 1::2, 1::2] = np.asarray(outs[3])
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # woven caller (library API): quad planes + u16-packed column weave
    wov = np.asarray(
        jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=True, planes_out=False,
            )
        )(jnp.asarray(img), banks)
    )
    np.testing.assert_array_equal(wov, got)
    # woven fallback path (upscale_precas_mxu, used by DOUBLE)
    x = jnp.moveaxis(jnp.asarray(img, jnp.float32) / 255.0, -1, -3)
    v = mxu_pipeline.upscale_precas_mxu(x, plan, banks)
    u2 = float(np.float32(plan.upscale)) ** 2
    wantv = np.empty((3, 2 * h, 2 * w))
    for ch in range(3):
        F = np.fft.rfft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        wantv[ch] = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    assert np.abs(np.asarray(v, np.float64) - wantv).max() < 2e-3


def test_staged_double_any_size_banks_and_accuracy():
    """DOUBLE routes through staged f64 banks at EVERY size (a few MB vs
    the dense tier's O(n^2) f64 banks) and holds fp64-grade accuracy."""
    from vkresample_tpu.fft import mxu_pipeline

    plan = UpscalePlan(
        h=32, w=128, upscale=2.0, precision=Precision.DOUBLE,
        engine=Engine.MXU,
    )
    banks = mxu_pipeline.make_dense_banks(plan, "float64")
    assert banks is not None and "stx_b1" in banks
    assert banks["stx_b1"].dtype == np.float64
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (32, 128, 3), np.uint8)
    with jax.enable_x64():
        x = jnp.moveaxis(jnp.asarray(img, jnp.float64) / 255.0, -1, -3)
        v = mxu_pipeline.upscale_precas_mxu(
            x, plan, jax.device_put(banks)
        )
        got = np.asarray(v, np.float64)
    u2 = float(np.float32(plan.upscale)) ** 2
    want = np.empty((3, 64, 256))
    for ch in range(3):
        F = np.fft.rfft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        want[ch] = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    assert np.abs(got - want).max() < 1e-10


def test_staged_quad_matches_dense_quad_f32():
    """No-codec f32 path (SINGLE-mode analog) against dense.r2c_quad."""
    plan = UpscalePlan(
        h=32, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (3, 32, 128), np.uint8)
    dbanks = dense.r2c_rows_banks(plan, "float32")
    sbanks = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    Pd = dense.r2c_quad(jnp.asarray(img), dbanks, HIGHEST)
    Ps = staged.r2c_quad_staged(jnp.asarray(img), sbanks, HIGHEST)
    for a, b in zip(Pd, Ps):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-4


@pytest.mark.parametrize(
    "variant", ["batchy", "f32y", "barrier", "batchy,f32y", "qbar", "qf32"]
)
def test_staged_quad_variants_match_baseline(monkeypatch, variant):
    """The composition variants (VKRESAMPLE_STAGED_VARIANT) are algebraic
    re-groupings of the same transform: batchy/barrier are exact; f32y
    skips the i16 dequant (deviation bounded by the codec step)."""
    plan = UpscalePlan(
        h=96, w=384, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (96, 384, 3), np.uint8)
    banks = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    assert "st_y1n" in banks  # corrections active: dc_add path exercised
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    base = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
    monkeypatch.setenv("VKRESAMPLE_STAGED_VARIANT", variant)
    got = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
    # f32y skips the dequant; qf32 rounds the colsum — both bounded
    tol = 2 if ("f32y" in variant or "qf32" in variant) else 0
    for a, b in zip(base, got):
        d = np.abs(
            np.asarray(a, np.int32) - np.asarray(b, np.int32)
        ).max()
        assert d <= tol, (variant, d)


def test_staged_bf16_intermediates_runs_and_bounds(monkeypatch):
    """bf16 spectral intermediates (VKRESAMPLE_STAGED_INTERMEDIATE=bf16):
    REJECTED for default use — measured ~158 Q2.14 units (~2.5 u8 LSB)
    at 96x384, backend-independent (random-walk of 2^-9 roundings over
    K~128 contractions).  The knob stays for bandwidth experiments where
    tolerance is looser; this test pins the deviation band."""
    plan = UpscalePlan(
        h=96, w=384, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (96, 384, 3), np.uint8)
    banks = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    base = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
    for mode, lo, hi in (
        ("bf16", 32, 512), ("bf16store", 32, 512), ("i16", 1, 64),
        # centered bf16 (exact DC-gain add-back): measurably better than
        # bf16store (101 vs 140 units here) but still ~4 u8 LSB e2e on
        # flat-spectrum inputs — a single 2^-9 relative rounding of a
        # ~sqrt(n2)*sigma-sized bin is already ~1 u8; REJECTED as default
        ("bf16c", 32, 512),
    ):
        monkeypatch.setenv("VKRESAMPLE_STAGED_INTERMEDIATE", mode)
        got = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
        ds = [
            np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max()
            for a, b in zip(base, got)
        ]
        # P00 bypasses the convs (samples + rank-1) and stays exact; the
        # conv-produced planes deviate, but boundedly (the i16 codec's
        # absolute L1-bound scaling is ~7x tighter than bf16's relative
        # rounding at this size: ~21 vs ~147 Q2.14 units)
        assert lo <= max(ds) <= hi, (mode, ds)


def _weave_grid(Ps, u, h, w, scale):
    got = np.zeros((3, u * h, u * w))
    for i, (ry, rx) in enumerate(
        [(a, b) for a in range(u) for b in range(u)]
    ):
        got[:, ry::u, rx::u] = np.asarray(Ps[i], np.float64) * scale
    return got


def _precas_oracle(img, plan):
    u2 = float(np.float32(plan.upscale)) ** 2
    want = np.empty((3, plan.H, plan.W))
    for ch in range(3):
        F = np.fft.rfft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        want[ch] = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    return want


@pytest.mark.parametrize(
    "h,w,u",
    [
        (64, 128, 3),
        (32, 128, 4),
        (48, 360, 3),  # non-128-aligned width (lane-padding route, r5)
    ],
)
def test_grid_staged_matches_oracle(h, w, u):
    """u-generic grid transform (u^2 phase planes) vs the oracle, with
    the i16 storage codec active (the production half-mode form)."""
    plan = UpscalePlan(
        h=h, w=w, upscale=float(u), precision=Precision.HALF,
        engine=Engine.MXU,
    )
    assert staged.grid_supported(plan)
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.r2c_grid_staged_banks(plan).items()
    }
    assert staged.grid_u(banks) == u
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    Ps = staged.r2c_grid_staged(x_raw, banks, HIGHEST, **codec)
    assert len(Ps) == u * u
    got = _weave_grid(Ps, u, h, w, 1.0 / 16384.0)
    assert np.abs(got - _precas_oracle(img, plan)).max() < 2e-3


def test_grid_staged_u2_matches_quad():
    """The u=2 member of the grid family reproduces the tuned quad route
    exactly (same kernels, same correction algebra)."""
    plan = UpscalePlan(
        h=32, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (3, 32, 128), np.uint8)
    qb = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    gb = {
        k: jnp.asarray(v) for k, v in staged.r2c_grid_staged_banks(plan).items()
    }
    Pq = staged.r2c_quad_staged(jnp.asarray(img), qb, HIGHEST)
    Pg = staged.r2c_grid_staged(jnp.asarray(img), gb, HIGHEST)
    for a, b in zip(Pq, Pg):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5


def test_grid_staged_odd_n1_post_path():
    """h=882 (n1=21, odd) exercises the post-multiply correction branch
    of the grid transform at u=3."""
    plan = UpscalePlan(
        h=882, w=128, upscale=3.0, precision=Precision.HALF, engine=Engine.MXU
    )
    assert staged.grid_supported(plan)
    assert staged.split_factors(882)[0] % 2 == 1
    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (882, 128, 3), np.uint8)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.r2c_grid_staged_banks(plan).items()
    }
    assert "sg_y1n" in banks
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    Ps = staged.r2c_grid_staged(x_raw, banks, HIGHEST)
    got = _weave_grid(Ps, 3, 882, 128, 1.0)
    assert np.abs(got - _precas_oracle(img, plan)).max() < 2e-3


def test_staged_quad_odd_n1_post_path():
    """h=882 splits as n1=21 (ODD), forcing the post-multiply y-Nyquist
    correction branch (pow2 sizes always take the even-n1 DC-bin
    injection) — plus odd-n2 Hermitian pair weights in the x conv."""
    plan = UpscalePlan(
        h=882, w=384, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    assert staged.staged_supported(plan)
    assert staged.split_factors(882)[0] % 2 == 1
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (882, 384, 3), np.uint8)
    banks = {
        k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()
    }
    assert "st_y1n" in banks  # correction active, so the post path runs
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    Ps = staged.r2c_quad_staged(x_raw, banks, HIGHEST, **codec)
    got = np.zeros((3, 1764, 768))
    got[:, 0::2, 0::2] = np.asarray(Ps[0], np.float64) / 16384.0
    got[:, 0::2, 1::2] = np.asarray(Ps[1], np.float64) / 16384.0
    got[:, 1::2, 0::2] = np.asarray(Ps[2], np.float64) / 16384.0
    got[:, 1::2, 1::2] = np.asarray(Ps[3], np.float64) / 16384.0
    u2 = float(np.float32(plan.upscale)) ** 2
    want = np.empty((3, 1764, 768))
    for ch in range(3):
        F = np.fft.rfft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        want[ch] = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    assert np.abs(got - want).max() < 2e-3


def test_pipeline_grid_banks_route(monkeypatch):
    """u=3 big-tier routing e2e: make_dense_banks returns grid banks,
    planes_format reports 'grid', _pipeline's u^2 plane output matches
    the oracle, the woven caller agrees with the planes weave, and the
    upscale_precas_mxu fallback handles grid banks."""
    import functools

    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.io.png import weave_grid_host
    from vkresample_tpu.pipeline import upscale as up

    # h=32 is the smallest height with a Cooley-Tukey split (16 has
    # none); the parity CAS math is covered in test_cas_pallas
    plan = UpscalePlan(
        h=32, w=128, upscale=3.0, precision=Precision.HALF, engine=Engine.MXU
    )
    monkeypatch.setattr(mxu_pipeline, "DENSE_MAX", 64)
    assert mxu_pipeline.big_grid_selected(plan)
    assert up.planes_format(plan) == "grid"
    banks = mxu_pipeline.make_dense_banks(plan, "float32", planes=True)
    assert banks is not None and "sgx1_b1" in banks
    assert staged.grid_u(banks) == 3
    banks = jax.device_put({k: jnp.asarray(v) for k, v in banks.items()})
    img = np.random.default_rng(13).integers(0, 256, (32, 128, 3), np.uint8)
    outs = jax.jit(
        functools.partial(
            up._pipeline, plan=plan, engine=Engine.MXU,
            planar_out=True, planes_out=True,
        )
    )(jnp.asarray(img), banks)
    assert len(outs) == 9
    got = weave_grid_host([np.asarray(p) for p in outs], 3)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # woven caller (library API): same pixels via the device u8 weave
    wov = np.asarray(
        jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=True, planes_out=False,
            )
        )(jnp.asarray(img), banks)
    )
    np.testing.assert_array_equal(wov, got)
    # woven fallback path (upscale_precas_mxu, used by DOUBLE)
    x = jnp.moveaxis(jnp.asarray(img, jnp.float32) / 255.0, -1, -3)
    v = mxu_pipeline.upscale_precas_mxu(x, plan, banks)
    assert np.abs(np.asarray(v, np.float64) - _precas_oracle(img, plan)).max() < 2e-3


def test_decimated_conv_matches_strided_circulant():
    """conv_banks(decimate=q) == full circulant conv sampled at stride q
    (the fractional tier's output lattice)."""
    rng = np.random.default_rng(11)
    n, q = 48, 2
    kernel = rng.standard_normal(n)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.conv_banks(kernel, "t_", n1=8, decimate=q).items()
    }
    x = rng.standard_normal((2, 3, n))
    out = staged.conv_apply_lanes(jnp.asarray(x), banks, "t_", HIGHEST)
    want = _circulant_ref(kernel, x)[..., ::q]
    assert out.shape == want.shape
    assert np.abs(np.asarray(out) - want).max() < 1e-4
    xr = np.moveaxis(x, -1, -2)
    out = staged.conv_apply_rows(jnp.asarray(xr), banks, "t_", HIGHEST)
    want_r = np.moveaxis(want, -1, -2)
    assert np.abs(np.asarray(out) - want_r).max() < 1e-4


@pytest.mark.parametrize(
    "h,w,u",
    [
        (64, 256, 1.5),
        (32, 512, 1.25),
        (64, 256, 2.5),
        (64, 512, 1.75),
        (96, 384, 1.3333334),  # non-dyadic q=3 (geometry-derived 4/3)
        (90, 640, 1.2),  # non-dyadic q=5 (6/5)
        (96, 360, 1.5),  # non-128-aligned w/q (lane-padding route, r5)
    ],
)
def test_frac_staged_matches_oracle(h, w, u):
    """Fractional-factor staged grid transform (u = p/q: p^2 phase planes
    of size (h/q, w/q), stride-q decimation folded into the banks) vs the
    oracle, with the i16 storage codec active.  1.75 = 7/4 pins the
    exotic-fraction case (p = 7 -> 49 phase planes): big exotic frames
    have no other surviving tier, so the grid must hold there too.
    1.3333334 / 1.2 pin NON-DYADIC q: the fraction comes from the
    integer geometry (H/h == W/w), not the float bits, and the plan's
    C-float band edges happen to realize the exact rational keep set on
    these frames (frames where they don't fall through — see
    test_big_frac_without_grid_route_fails_clean)."""
    plan = UpscalePlan(
        h=h, w=w, upscale=u, precision=Precision.HALF, engine=Engine.MXU
    )
    p, q = staged.frac_params(plan)
    assert staged.grid_supported(plan)
    rng = np.random.default_rng(17)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.r2c_grid_staged_banks(plan).items()
    }
    assert staged.grid_u(banks) == p
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    codec = dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage)
    Ps = staged.r2c_grid_staged(x_raw, banks, HIGHEST, **codec)
    assert len(Ps) == p * p
    assert Ps[0].shape[-2:] == (h // q, w // q)
    got = _weave_grid(Ps, p, h // q, w // q, 1.0 / 16384.0)
    assert np.abs(got - _precas_oracle(img, plan)).max() < 2e-3


def test_frac_params_accept_reject_geometry():
    # non-dyadic geometry where the C-float band math drops a y bin
    # (kept 29+30 != 60): the rational keep-set derivation doesn't hold,
    # so the route must decline even though H/h == W/w == 6/5
    plan = UpscalePlan(
        h=60, w=640, upscale=1.2, precision=Precision.HALF, engine=Engine.XLA
    )
    assert plan.H * 5 == plan.h * 6 and plan.W * 5 == plan.w * 6
    assert staged.frac_params(plan) is None
    # (w // q) % 128 != 0 is ACCEPTED (padding tax instead of the
    # phases route)
    plan = UpscalePlan(
        h=96, w=384, upscale=1.5, precision=Precision.HALF, engine=Engine.XLA
    )
    assert staged.frac_params(plan) == (3, 2)
    # integer factors are not "fractional"
    plan = UpscalePlan(
        h=64, w=256, upscale=2.0, precision=Precision.HALF, engine=Engine.XLA
    )
    assert staged.frac_params(plan) is None


def test_big_frac_without_grid_route_fails_clean():
    """A >DENSE_MAX fractional frame the staged grid cannot take (5/3:
    the C-float band math drops a y bin) must raise a clean ValueError
    instead of dispatching into the big-spectrum route, which
    materializes the full H x W complex spectrum and does not fit beyond
    the dense cap."""
    from vkresample_tpu.fft import mxu_pipeline

    plan = UpscalePlan(
        h=6144, w=6144, upscale=1.6666667, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    assert plan.mxu_mode == "big"  # 10240x10240: 7-smooth, fractional
    assert staged.frac_params(plan) is None
    assert mxu_pipeline.make_dense_banks(plan) is None
    with pytest.raises(ValueError, match="staged fractional grid"):
        jax.eval_shape(
            lambda x: mxu_pipeline.upscale_precas_mxu(x, plan),
            jax.ShapeDtypeStruct((3, 6144, 6144), jnp.float32),
        )


def test_pipeline_frac_banks_route(monkeypatch):
    """Fractional big-tier routing e2e: make_dense_banks returns grid
    banks with decimation, planes_format reports 'grid', the p^2 plane
    output matches the oracle, and the woven caller agrees."""
    import functools

    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.io.png import weave_grid_host
    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=64, w=256, upscale=1.5, precision=Precision.HALF, engine=Engine.MXU
    )
    monkeypatch.setattr(mxu_pipeline, "DENSE_MAX", 64)
    assert mxu_pipeline.big_grid_selected(plan)
    assert up.planes_format(plan) == "grid"
    banks = mxu_pipeline.make_dense_banks(plan, "float32", planes=True)
    assert banks is not None and "sgx1_b1" in banks
    assert staged.grid_u(banks) == 3
    banks = jax.device_put({k: jnp.asarray(v) for k, v in banks.items()})
    img = np.random.default_rng(29).integers(0, 256, (64, 256, 3), np.uint8)
    outs = jax.jit(
        functools.partial(
            up._pipeline, plan=plan, engine=Engine.MXU,
            planar_out=True, planes_out=True,
        )
    )(jnp.asarray(img), banks)
    assert len(outs) == 9
    assert outs[0].shape == (3, 32, 128)
    got = weave_grid_host([np.asarray(p) for p in outs], 3)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # woven caller (library API): same pixels via the device u8 weave
    wov = np.asarray(
        jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=True, planes_out=False,
            )
        )(jnp.asarray(img), banks)
    )
    np.testing.assert_array_equal(wov, got)
    # woven fallback path (upscale_precas_mxu, used by DOUBLE)
    x = jnp.moveaxis(jnp.asarray(img, jnp.float32) / 255.0, -1, -3)
    v = mxu_pipeline.upscale_precas_mxu(x, plan, banks)
    assert np.abs(np.asarray(v, np.float64) - _precas_oracle(img, plan)).max() < 2e-3


def _precas_oracle_c2c(img, plan):
    """c2c pre-CAS magnitude oracle (CAS consumes length(),
    VkResample.cpp:904)."""
    u2 = float(np.float32(plan.upscale)) ** 2
    want = np.empty((3, plan.H, plan.W))
    for ch in range(3):
        F = np.fft.fft2(img[:, :, ch].astype(np.float64) / 255.0)
        G = oracle.assemble_big_spectrum(F, plan)
        want[ch] = np.abs(u2 * np.fft.ifft2(G))
    return want


@pytest.mark.parametrize(
    "h,w,u",
    [
        (48, 256, 2.0),
        (36, 384, 3.0),
        (48, 256, 1.5),
        (32, 512, 1.25),
        (64, 512, 1.75),  # exotic p=7 (49 planes): the >cap c2c grid form
        (96, 384, 1.3333334),  # non-dyadic q=3 (geometry-derived 4/3)
        (48, 360, 1.5),  # non-128-aligned w/q (lane-padding route, r5)
    ]
)
def test_c2c_grid_staged_matches_oracle(h, w, u):
    """c2c staged grid transform (complex planes via the rank-1 Nyquist
    algebra, magnitude output) vs the oracle — integer AND fractional
    factors, with and without the i16 storage codec."""
    plan = UpscalePlan(
        h=h, w=w, upscale=u, r2c=False, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    params = staged.c2c_grid_params(plan)
    assert params is not None
    p, q = params
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.c2c_grid_staged_banks(plan).items()
    }
    assert staged.c2c_grid_u(banks) == p
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    want = _precas_oracle_c2c(img, plan)
    for codec, tol in (
        ({}, 2e-4),
        (dict(store=cas_ops.to_i16_storage, load=cas_ops.from_i16_storage),
         2e-3),
    ):
        Ps = staged.c2c_grid_staged(x_raw, banks, HIGHEST, **codec)
        assert len(Ps) == p * p
        assert Ps[0].shape[-2:] == (h // q, w // q)
        scale = 1.0 / 16384.0 if codec else 1.0
        got = _weave_grid(Ps, p, h // q, w // q, scale)
        assert np.abs(got - want).max() < tol


def test_c2c_grid_params_rejects():
    # r2c plans use the r2c grid routes
    plan = UpscalePlan(
        h=64, w=256, upscale=2.0, precision=Precision.HALF, engine=Engine.XLA
    )
    assert staged.c2c_grid_params(plan) is None
    # u = 1: nothing to upscale
    plan = UpscalePlan(
        h=64, w=256, upscale=1.0, r2c=False, precision=Precision.HALF,
        engine=Engine.XLA,
    )
    assert staged.c2c_grid_params(plan) is None
    # non-dyadic float (astronomical exact denominator)
    plan = UpscalePlan(
        h=60, w=640, upscale=1.2, r2c=False, precision=Precision.HALF,
        engine=Engine.XLA,
    )
    assert staged.c2c_grid_params(plan) is None
    # (w // q) % 128 != 0 is ACCEPTED (padding tax instead of the
    # phases route) — see x_split_prefer
    plan = UpscalePlan(
        h=96, w=384, upscale=1.5, r2c=False, precision=Precision.HALF,
        engine=Engine.XLA,
    )
    assert staged.c2c_grid_params(plan) == (3, 2)


@pytest.mark.parametrize(
    "h,u,nplanes,pshape",
    [(32, 2.0, 4, (3, 32, 256)), (64, 1.5, 9, (3, 32, 128))],
)
def test_pipeline_c2c_grid_route(monkeypatch, h, u, nplanes, pshape):
    """c2c big-tier routing e2e: make_dense_banks returns c2c grid banks,
    planes_format reports 'grid', the p^2 magnitude planes match the
    oracle through CAS, and the woven caller agrees."""
    import functools

    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.io.png import weave_grid_host
    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=h, w=256, upscale=u, r2c=False, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    monkeypatch.setattr(mxu_pipeline, "DENSE_MAX", 64)
    assert mxu_pipeline.big_grid_selected(plan)
    assert up.planes_format(plan) == "grid"
    banks = mxu_pipeline.make_dense_banks(plan, "float32", planes=True)
    assert banks is not None and "cg_ay" in banks
    p = int(round(nplanes ** 0.5))
    assert staged.c2c_grid_u(banks) == p
    banks = jax.device_put({k: jnp.asarray(v) for k, v in banks.items()})
    img = np.random.default_rng(31).integers(0, 256, (h, 256, 3), np.uint8)
    outs = jax.jit(
        functools.partial(
            up._pipeline, plan=plan, engine=Engine.MXU,
            planar_out=True, planes_out=True,
        )
    )(jnp.asarray(img), banks)
    assert len(outs) == nplanes
    assert outs[0].shape == pshape
    got = weave_grid_host([np.asarray(pl) for pl in outs], p)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # woven caller (library API): same pixels via the device u8 weave
    wov = np.asarray(
        jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=True, planes_out=False,
            )
        )(jnp.asarray(img), banks)
    )
    np.testing.assert_array_equal(wov, got)
    # woven fallback path (upscale_precas_mxu, used by DOUBLE)
    x = jnp.moveaxis(jnp.asarray(img, jnp.float32) / 255.0, -1, -3)
    v = mxu_pipeline.upscale_precas_mxu(x, plan, banks)
    assert np.abs(
        np.asarray(v, np.float64) - _precas_oracle_c2c(img, plan)
    ).max() < 2e-3


def test_staged_double_grid_and_c2c_banks_and_accuracy():
    """DOUBLE routes u>=3 r2c AND c2c plans through f64 GRID staged banks
    at every size (previously big DOUBLE grid/c2c frames fell to the f64
    phases/big-spectrum routes, which do not survive >8K)."""
    from vkresample_tpu.fft import mxu_pipeline

    # u=3 r2c grid
    plan = UpscalePlan(
        h=36, w=384, upscale=3.0, precision=Precision.DOUBLE,
        engine=Engine.MXU,
    )
    banks = mxu_pipeline.make_dense_banks(plan, "float64")
    assert banks is not None and "sgx1_b1" in banks
    assert banks["sgx1_b1"].dtype == np.float64
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (36, 384, 3), np.uint8)
    with jax.enable_x64():
        x = jnp.moveaxis(jnp.asarray(img, jnp.float64) / 255.0, -1, -3)
        v = mxu_pipeline.upscale_precas_mxu(x, plan, jax.device_put(banks))
        got = np.asarray(v, np.float64)
    assert np.abs(got - _precas_oracle(img, plan)).max() < 1e-10

    # c2c grid
    plan = UpscalePlan(
        h=48, w=256, upscale=2.0, r2c=False, precision=Precision.DOUBLE,
        engine=Engine.MXU,
    )
    banks = mxu_pipeline.make_dense_banks(plan, "float64")
    assert banks is not None and "cg_ay" in banks
    assert banks["cg_ay"].dtype == np.float64
    img = rng.integers(0, 256, (48, 256, 3), np.uint8)
    with jax.enable_x64():
        x = jnp.moveaxis(jnp.asarray(img, jnp.float64) / 255.0, -1, -3)
        v = mxu_pipeline.upscale_precas_mxu(x, plan, jax.device_put(banks))
        got = np.asarray(v, np.float64)
    assert np.abs(got - _precas_oracle_c2c(img, plan)).max() < 1e-10


def test_c2c_routes_grid_at_every_size(monkeypatch):
    """The c2c staged grid is the default route at EVERY size (the dense
    5-matmul complex chain stays behind VKRESAMPLE_C2C=dense)."""
    from vkresample_tpu.fft import mxu_pipeline

    plan = UpscalePlan(
        h=48, w=256, upscale=2.0, r2c=False, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    banks = mxu_pipeline.make_dense_banks(plan, "float32")
    assert banks is not None and "cg_ay" in banks
    monkeypatch.setenv("VKRESAMPLE_C2C", "dense")
    banks = mxu_pipeline.make_dense_banks(plan, "float32")
    assert banks is not None and "cg_ay" not in banks


def test_c2c_exotic_fraction_stays_dense_below_cap():
    """-u 2.75 (= 11/4 -> 121 phase planes) keeps the dense c2c chain
    below DENSE_MAX; above the cap the grid is the only surviving tier,
    any p."""
    from vkresample_tpu.fft import mxu_pipeline

    plan = UpscalePlan(
        h=64, w=512, upscale=2.75, r2c=False, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    assert staged.c2c_grid_params(plan) == (11, 4)
    assert not mxu_pipeline.c2c_grid_selected(plan)
    banks = mxu_pipeline.make_dense_banks(plan, "float32")
    assert banks is not None and "cg_ay" not in banks


def test_frac_grid_optin_below_cap(monkeypatch):
    """VKRESAMPLE_FRAC=grid opts small fractional r2c frames onto the
    grid staged route (default below DENSE_MAX stays the dense
    big-spectrum mode); the opted-in route matches the oracle."""
    import functools

    from vkresample_tpu.fft import mxu_pipeline
    from vkresample_tpu.io.png import weave_grid_host
    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=64, w=256, upscale=1.5, precision=Precision.HALF, engine=Engine.MXU
    )
    assert not mxu_pipeline.big_grid_selected(plan)
    banks = mxu_pipeline.make_dense_banks(plan, "float32")
    assert banks is not None and "sgx1_b1" not in banks
    monkeypatch.setenv("VKRESAMPLE_FRAC", "grid")
    assert mxu_pipeline.big_grid_selected(plan)
    assert up.planes_format(plan) in (None, "grid")
    banks = mxu_pipeline.make_dense_banks(plan, "float32", planes=True)
    assert banks is not None and "sgx1_b1" in banks
    banks = jax.device_put({k: jnp.asarray(v) for k, v in banks.items()})
    img = np.random.default_rng(37).integers(0, 256, (64, 256, 3), np.uint8)
    outs = jax.jit(
        functools.partial(
            up._pipeline, plan=plan, engine=Engine.MXU,
            planar_out=True, planes_out=True,
        )
    )(jnp.asarray(img), banks)
    got = weave_grid_host([np.asarray(p) for p in outs], 3)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_channel_serial_matches_batched(monkeypatch):
    """VKRESAMPLE_CHANNEL_SERIAL=1 runs channels as a device-side lax.map
    loop (huge-frame HBM cap, the reference's per-coordinate dispatch loop
    vkFFT.h:7640-7646); outputs must match the batched route on every
    output surface (quad planes, woven, non-planar)."""
    import functools

    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=32, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    banks = jax.device_put(
        {k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()}
    )
    img = np.random.default_rng(23).integers(0, 256, (32, 128, 3), np.uint8)

    def run(planes_out, planar_out):
        return jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=planar_out, planes_out=planes_out,
            )
        )(jnp.asarray(img), banks)

    # fresh closures per env value: the jit cache ignores env changes
    monkeypatch.delenv("VKRESAMPLE_CHANNEL_SERIAL", raising=False)
    ref_planes = [np.asarray(p) for p in run(True, True)]
    ref_woven = np.asarray(run(False, False))
    monkeypatch.setenv("VKRESAMPLE_CHANNEL_SERIAL", "1")
    got_planes = [np.asarray(p) for p in run(True, True)]
    got_woven = np.asarray(run(False, False))
    for g, r in zip(got_planes, ref_planes):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got_woven.shape == ref_woven.shape
    np.testing.assert_array_equal(got_woven, ref_woven)
    # the auto gate (CHANNEL_SERIAL_ELEMS): the 3-channel 16K->32K frame
    # stays batched, the next tier up serializes
    monkeypatch.delenv("VKRESAMPLE_CHANNEL_SERIAL", raising=False)
    assert not up._channel_serial(plan, jnp.asarray(img))
    big16 = UpscalePlan(
        h=8192, w=16384, upscale=2.0, precision=Precision.HALF,
        engine=Engine.MXU, channels=3,
    )
    assert not up._channel_serial(
        big16, jax.ShapeDtypeStruct((8192, 16384, 3), jnp.uint8)
    )
    big32 = UpscalePlan(
        h=16384, w=32768, upscale=2.0, precision=Precision.HALF,
        engine=Engine.MXU, channels=3,
    )
    assert up._channel_serial(
        big32, jax.ShapeDtypeStruct((16384, 32768, 3), jnp.uint8)
    )
    # batched (leading-dim) inputs take the same gate (dp-sharded huge
    # frames run channel-serial per device)
    assert up._channel_serial(
        big32, jax.ShapeDtypeStruct((4, 16384, 32768, 3), jnp.uint8)
    )


def test_channel_serial_batched_matches(monkeypatch):
    """The channel-serial lax.map route is batch-polymorphic:
    with a leading frame dim, every output surface must match the
    batched-channels route elementwise and keep the (N, C, ...) planar
    axis order."""
    import functools

    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(
        h=32, w=128, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    banks = jax.device_put(
        {k: jnp.asarray(v) for k, v in staged.r2c_quad_staged_banks(plan).items()}
    )
    imgs = np.random.default_rng(29).integers(0, 256, (2, 32, 128, 3), np.uint8)

    def run(planes_out, planar_out):
        return jax.jit(
            functools.partial(
                up._pipeline, plan=plan, engine=Engine.MXU,
                planar_out=planar_out, planes_out=planes_out,
            )
        )(jnp.asarray(imgs), banks)

    monkeypatch.delenv("VKRESAMPLE_CHANNEL_SERIAL", raising=False)
    ref_planes = [np.asarray(p) for p in run(True, True)]
    ref_woven = np.asarray(run(False, False))
    monkeypatch.setenv("VKRESAMPLE_CHANNEL_SERIAL", "1")
    got_planes = [np.asarray(p) for p in run(True, True)]
    got_woven = np.asarray(run(False, False))
    for g, r in zip(got_planes, ref_planes):
        assert g.shape == r.shape  # (N, C, H', W')
        np.testing.assert_array_equal(g, r)
    assert got_woven.shape == ref_woven.shape  # (N, H, W, C)
    np.testing.assert_array_equal(got_woven, ref_woven)


def test_x_split_prefer_lane_exact(monkeypatch):
    """The staged x (lanes) convs prefer n1 = 128*q so BOTH the input
    view (..., n2, n1) and S3's natural "...ed" output view are
    128-exact in their minor dim.  Pins the preference, the q scaling,
    and the env override."""
    monkeypatch.delenv("VKRESAMPLE_XSPLIT", raising=False)
    assert staged.x_split_prefer() == 128
    assert staged.x_split_prefer(4) == 512
    assert staged.split_factors(8192, staged.x_split_prefer()) == (128, 64)
    # decimated: n1 = 128*q keeps nd = n1/q on exactly 128 lanes
    n1, n2 = staged.split_factors(
        8192, staged.x_split_prefer(4), multiple_of=4
    )
    assert n1 == 512 and n1 // 4 == 128
    # quad banks land the preference end to end
    plan = UpscalePlan(
        h=256, w=1024, upscale=2.0, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    banks = staged.r2c_quad_staged_banks(plan)
    assert (banks["stx_m"].shape[2], banks["stx_b1"].shape[0]) == (128, 8)
    monkeypatch.setenv("VKRESAMPLE_XSPLIT", "64")
    assert staged.x_split_prefer() == 64


def test_x_split_prefer_non_aligned_window(monkeypatch):
    """Widths 128*q does not divide pick the divisor in the window
    [64q, 320q] minimizing summed padding waste across the S1 input
    (n1) and S3 output (n1/q) views — this keeps any even 7-smooth width
    on the staged tier (reference: vkFFT schedules any 7-smooth size,
    vkFFT.h:4707-5189).  Pins the picks: 8640 = 2^6*3^3*5 -> n1=120
    (pads to 128, ~6.7%/view) and 10080 = 2^5*3^2*5*7 -> n1=126 (pads
    to 128, ~1.6%/view)."""
    monkeypatch.delenv("VKRESAMPLE_XSPLIT", raising=False)
    assert staged.x_split_prefer(n=8640) == 120
    assert staged.x_split_prefer(n=10080) == 126
    # aligned widths keep the lane-exact 128*q preference (and its
    # n2 <= 64 doubling) — the window only engages when no lane-exact
    # split exists
    assert staged.x_split_prefer(n=8192) == 128
    # decimated non-aligned: the divisor stays a multiple of q
    n1 = staged.x_split_prefer(2, n=8640)
    assert n1 % 2 == 0 and 8640 % n1 == 0


def test_conv_apply_rows_epilogue_bit_exact():
    """The pre-flatten 4D epilogue is bit-identical to applying the same
    elementwise function (with row-broadcasts reshaped to the (n2, nd)
    split) on the flattened output — the contract the c2c magnitude
    fusion relies on (fft/staged.py c2c_planes_from_pencils)."""
    rng = np.random.default_rng(11)
    k = rng.random(64)
    banks = {
        key: jnp.asarray(v) for key, v in staged.conv_banks(k, "t_").items()
    }
    n2 = banks["t_b1"].shape[0]
    nd = banks["t_m"].shape[4]
    x = jnp.asarray(rng.random((3, 64, 128)).astype(np.float32))
    rowv = jnp.asarray(rng.random((64, 1)).astype(np.float32))  # per-row
    lanev = jnp.asarray(rng.random((128,)).astype(np.float32))

    def g4(y4):  # (..., e=n2, d=nd, L) view
        return jnp.sqrt(y4 * y4 + (rowv.reshape(n2, nd, 1) * lanev) ** 2)

    hi = jax.lax.Precision.HIGHEST
    fused = staged.conv_apply_rows(x, banks, "t_", hi, epilogue=g4)
    flat = staged.conv_apply_rows(x, banks, "t_", hi)
    want = jnp.sqrt(flat * flat + (rowv * lanev) ** 2)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(want))
    # deferred-load composition: load applies inside the split view
    enc = lambda t: (t * 16384.0).astype(jnp.int16)
    dec = lambda t: t.astype(jnp.float32) * (1.0 / 16384.0)
    fused2 = staged.conv_apply_rows(
        enc(x), banks, "t_", hi, load=dec, epilogue=g4
    )
    flat2 = staged.conv_apply_rows(dec(enc(x)), banks, "t_", hi)
    want2 = jnp.sqrt(flat2 * flat2 + (rowv * lanev) ** 2)
    np.testing.assert_array_equal(np.asarray(fused2), np.asarray(want2))
