"""Parity-plane CAS + quantize (ops/cas.py cas_parity_planes) vs the fp64
oracle and vs the woven CAS, plus the Pallas Triton kernel of the same
stencil in interpret mode (its compiled form runs on the GPU through
chip_smoke.py)."""
import numpy as np
import pytest
from jax import numpy as jnp

from vkresample_tpu.ops import cas as cas_ops
from vkresample_tpu.ops.cas import cas_parity_planes
from vkresample_tpu.oracle import numpy_ref as oracle


def _want(v, s):
    return np.stack(
        [
            oracle.quantize_u8(
                oracle.cas_sharpen(v[c].astype(np.float64), s)
            )
            for c in range(v.shape[0])
        ]
    )


def _cas1(v, s):
    """The woven image as a 1 x 1 parity grid."""
    (out,) = cas_parity_planes([v], s, 1)
    return np.asarray(out)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("shape", [(3, 64, 256), (1, 32, 128), (3, 48, 384)])
def test_pallas_cas_matches_oracle(shape):
    rng = np.random.default_rng(shape[1])
    v = (rng.random(shape).astype(np.float32) * 1.3 - 0.1)  # incl. out-of-range
    got = _cas1(jnp.asarray(v), 0.2)
    assert np.abs(got.astype(int) - _want(v, 0.2).astype(int)).max() <= 1


def test_pallas_cas_sharpen_zero():
    rng = np.random.default_rng(7)
    v = rng.random((1, 32, 128)).astype(np.float32)
    got = _cas1(jnp.asarray(v), 0.0)
    assert np.abs(got.astype(int) - _want(v, 0.0).astype(int)).max() <= 1


def test_pallas_cas_fallback_degenerate_width():
    # W not a lane multiple: whole planes have no degenerate geometry
    rng = np.random.default_rng(9)
    v = rng.random((2, 16, 100)).astype(np.float32)
    got = _cas1(jnp.asarray(v), 0.2)
    assert np.abs(got.astype(int) - _want(v, 0.2).astype(int)).max() <= 1


def _rows_planes(U, O, u):
    """Row-split U (sample rows) + O (non-sample rows, O[t*(u-1)+k] =
    out[u*t+k+1]) as the u x 1 parity grid."""
    h, W = U.shape[-2:]
    O4 = O.reshape(O.shape[:-2] + (h, u - 1, W))
    return [U] + [O4[..., k, :] for k in range(u - 1)]


def _weave_rows_host(planes, u):
    c, h, W = np.asarray(planes[0]).shape
    got = np.zeros((c, u * h, W), np.uint8)
    for ry, p in enumerate(planes):
        got[:, ry::u] = np.asarray(p)
    return got


def test_rows_fused_kernel_matches_oracle():
    import jax

    from vkresample_tpu.core.config import Engine
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense, mxu_pipeline

    for u, h, w in [(2, 64, 128), (3, 48, 96)]:
        plan = UpscalePlan(h=h, w=w, upscale=float(u), engine=Engine.MXU)
        banks = mxu_pipeline.make_dense_banks(plan)
        rng = np.random.default_rng(u)
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
        U, O = dense.r2c_rows(x_raw, banks, jax.lax.Precision.HIGHEST)
        outs = cas_parity_planes(_rows_planes(U, O, u), 0.2, u, 1)
        got = _weave_rows_host(outs, u)
        want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (u, h, w)


def test_parity_fused_kernel_matches_oracle():
    import jax

    from vkresample_tpu.core.config import Engine
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense, mxu_pipeline

    h, w = 64, 128
    plan = UpscalePlan(h=h, w=w, upscale=2.0, engine=Engine.MXU)
    banks = mxu_pipeline.make_dense_banks(plan)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    U, O = dense.r2c_rows(x_raw, banks, jax.lax.Precision.HIGHEST)
    got = _weave_rows_host(cas_parity_planes([U, O], 0.2, 2, 1), 2)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_i16_storage_roundtrip_resolution():
    from vkresample_tpu.ops.cas import from_i16_storage, to_i16_storage

    rng = np.random.default_rng(17)
    v = (rng.random((4, 256)).astype(np.float32) * 2.6 - 0.3)  # incl. >2 tails
    back = np.asarray(from_i16_storage(to_i16_storage(jnp.asarray(v))))
    inrange = np.abs(v) < 1.99
    assert np.abs(back - v)[inrange].max() <= 0.5 / 16384
    # out-of-range values saturate but stay on the same side of the CAS clip
    assert np.all(np.abs(np.clip(np.abs(back), 0, 1) - np.clip(np.abs(v), 0, 1)) <= 1e-4)


def test_pallas_cas_i16_input_matches_oracle():
    """Half-mode storage: an int16 Q2.14 pre-CAS image through the parity
    CAS matches the f64 oracle within 1 LSB, aligned and odd widths."""
    from vkresample_tpu.ops.cas import to_i16_storage

    rng = np.random.default_rng(23)
    v = rng.random((3, 64, 256)).astype(np.float32) * 1.3 - 0.1
    vi = to_i16_storage(jnp.asarray(v))
    assert vi.dtype == jnp.int16
    got = _cas1(vi, 0.2)
    assert np.abs(got.astype(int) - _want(v, 0.2).astype(int)).max() <= 1
    v2 = rng.random((2, 16, 100)).astype(np.float32)
    got2 = _cas1(to_i16_storage(jnp.asarray(v2)), 0.2)
    assert np.abs(got2.astype(int) - _want(v2, 0.2).astype(int)).max() <= 1


def test_half_mode_i16_route_end_to_end():
    """Half-mode route: split-bf16 x matmul -> i16 storage -> per-parity
    CAS on the row planes; pixels within 1 LSB of the oracle."""
    import jax

    from vkresample_tpu.core.config import Engine, Precision
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense, mxu_pipeline
    from vkresample_tpu.ops.cas import to_i16_storage

    h, w = 64, 128
    plan = UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    banks = mxu_pipeline.make_dense_banks(plan)
    rng = np.random.default_rng(29)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    U, O = dense.r2c_rows(x_raw, banks, jax.lax.Precision.HIGHEST)
    outs = cas_parity_planes([to_i16_storage(U), to_i16_storage(O)], 0.2, 2, 1)
    got = _weave_rows_host(outs, 2)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_parity_planes_i16_matches_oracle():
    import jax

    from vkresample_tpu.core.config import Engine
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense, mxu_pipeline
    from vkresample_tpu.ops.cas import to_i16_storage

    h, w = 64, 128
    plan = UpscalePlan(h=h, w=w, upscale=2.0, engine=Engine.MXU)
    banks = mxu_pipeline.make_dense_banks(plan)
    rng = np.random.default_rng(41)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    U, O = dense.r2c_rows(x_raw, banks, jax.lax.Precision.HIGHEST)
    E, D = cas_parity_planes([to_i16_storage(U), to_i16_storage(O)], 0.2, 2, 1)
    got = np.stack([np.asarray(E), np.asarray(D)], axis=-2).reshape(3, 2 * h, 2 * w)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _quad_setup(h, w, seed):
    import jax

    from vkresample_tpu.core.config import Engine
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense, mxu_pipeline

    plan = UpscalePlan(h=h, w=w, upscale=2.0, engine=Engine.MXU)
    banks = mxu_pipeline.make_dense_banks(plan)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    Ps = dense.r2c_quad(x_raw, banks, jax.lax.Precision.HIGHEST)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    return Ps, want


def _weave4(outs, want_shape):
    got = np.zeros(want_shape, np.uint8)
    got[:, 0::2, 0::2] = np.asarray(outs[0])
    got[:, 0::2, 1::2] = np.asarray(outs[1])
    got[:, 1::2, 0::2] = np.asarray(outs[2])
    got[:, 1::2, 1::2] = np.asarray(outs[3])
    return got


def test_quad_parity_planes_matches_oracle():
    Ps, want = _quad_setup(64, 128, 43)
    outs = cas_parity_planes(Ps, 0.2, 2)
    got = _weave4(outs, want.shape)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_quad_parity_planes_i16_matches_oracle():
    from vkresample_tpu.ops.cas import to_i16_storage

    Ps, want = _quad_setup(64, 128, 44)
    Ps = [to_i16_storage(p) for p in Ps]
    outs = cas_parity_planes(Ps, 0.2, 2)
    got = _weave4(outs, want.shape)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_quad_parity_fallback_degenerate():
    Ps, want = _quad_setup(64, 50, 45)  # Wh=50 not a lane multiple
    outs = cas_parity_planes(Ps, 0.2, 2)
    got = _weave4(outs, want.shape)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _woven_cas(planes, uy, ux):
    """quantize_u8(cas_sharpen(.)) on the woven image of the planes."""
    f = [np.asarray(cas_ops.clip_unit(jnp.asarray(p))) for p in planes]
    c, h, w = f[0].shape
    v = np.zeros((c, uy * h, ux * w), np.float32)
    for i, p in enumerate(f):
        v[:, i // ux :: uy, i % ux :: ux] = p
    return np.asarray(cas_ops.quantize_u8(cas_ops.cas_sharpen(jnp.asarray(v), 0.2)))


def _weave_grid(outs, uy, ux):
    c, h, w = np.asarray(outs[0]).shape
    got = np.zeros((c, uy * h, ux * w), np.uint8)
    for i, p in enumerate(outs):
        got[:, i // ux :: uy, i % ux :: ux] = np.asarray(p)
    return got


def test_quad_parity_nonaligned_pad_path():
    """Non-128-aligned widths and odd heights: the plane CAS must agree
    with the woven-stencil evaluation on every cell, in f32 and i16."""
    from vkresample_tpu.ops.cas import to_i16_storage

    rng = np.random.default_rng(48)
    h, Wh = 44, 180
    planes_f = [
        jnp.asarray(rng.random((2, h, Wh), np.float32) * 1.2 - 0.1)
        for _ in range(4)
    ]
    for planes in (planes_f, [to_i16_storage(p) for p in planes_f]):
        got = cas_parity_planes(planes, 0.2, 2)
        assert all(o.shape == (2, h, Wh) for o in got)
        assert _maxdiff(_weave_grid(got, 2, 2), _woven_cas(planes, 2, 2)) <= 1


def test_grid_parity_nonaligned_pad_path():
    """u=3 grid planes with non-aligned width/height agree with the
    woven-stencil evaluation on every cell."""
    from vkresample_tpu.ops.cas import to_i16_storage

    rng = np.random.default_rng(49)
    u, h, Wp = 3, 68, 200
    planes_f = [
        jnp.asarray(rng.random((2, h, Wp), np.float32) * 1.2 - 0.1)
        for _ in range(u * u)
    ]
    for planes in (planes_f, [to_i16_storage(p) for p in planes_f]):
        got = cas_parity_planes(planes, 0.2, u)
        assert all(o.shape == (2, h, Wp) for o in got)
        assert _maxdiff(_weave_grid(got, u, u), _woven_cas(planes, u, u)) <= 1


def test_phases_quad_route_matches_oracle():
    """The >DENSE_MAX route composition: packed forward -> phase planes ->
    quad CAS (the phases ARE the parities), small shape."""
    from vkresample_tpu.core.config import Engine
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft.rfft2 import irfft2_phase_planes, rfft2_packed
    from vkresample_tpu.ops.cas import normalize_u8, to_i16_storage

    h, w = 64, 128
    plan = UpscalePlan(h=h, w=w, upscale=2.0, engine=Engine.MXU)
    rng = np.random.default_rng(47)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x = jnp.moveaxis(normalize_u8(jnp.asarray(img), jnp.float32), -1, 0)
    F = rfft2_packed(x)
    pl4 = irfft2_phase_planes(F, h, w, 2, plan.kept_hi_x > 0)
    Ps = [to_i16_storage(p) for p in (pl4[0][0], pl4[0][1], pl4[1][0], pl4[1][1])]
    outs = cas_parity_planes(Ps, 0.2, 2)
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    got = _weave4(outs, want.shape)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# u-generic grid-parity CAS (u >= 3)
# ---------------------------------------------------------------------------


def _weave_u(outs, u, want_shape):
    got = np.zeros(want_shape, np.uint8)
    for i, (ry, rx) in enumerate(
        [(a, b) for a in range(u) for b in range(u)]
    ):
        got[:, ry::u, rx::u] = np.asarray(outs[i])
    return got


def _grid_setup(h, w, u, seed):
    """Staged grid transform planes (i16 codec) + oracle for one image."""
    import jax

    from vkresample_tpu.core.config import Engine, Precision
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import staged
    from vkresample_tpu.ops.cas import from_i16_storage, to_i16_storage

    plan = UpscalePlan(
        h=h, w=w, upscale=float(u), precision=Precision.HALF,
        engine=Engine.MXU,
    )
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    banks = {
        k: jnp.asarray(v)
        for k, v in staged.r2c_grid_staged_banks(plan).items()
    }
    x_raw = jnp.moveaxis(jnp.asarray(img), -1, 0)
    Ps = staged.r2c_grid_staged(
        x_raw, banks, jax.lax.Precision.HIGHEST,
        store=to_i16_storage, load=from_i16_storage,
    )
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    return Ps, want


def test_grid_parity_planes_u3_matches_oracle():
    """Full e2e u=3: staged grid transform -> grid CAS vs oracle."""
    Ps, want = _grid_setup(64, 128, 3, 51)
    outs = cas_parity_planes(Ps, 0.2, 3)
    got = _weave_u(outs, 3, want.shape)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_grid_parity_planes_u4_strips():
    """u=4 wide planes: the plane CAS matches the woven full-array
    evaluation."""
    u = 4
    rng = np.random.default_rng(52)
    v = rng.standard_normal((2, u * 32, u * 1536)).astype(np.float32) * 0.6
    planes = [
        cas_ops.to_i16_storage(jnp.asarray(v[:, ry::u, rx::u]))
        for ry in range(u)
        for rx in range(u)
    ]
    outs = cas_parity_planes(planes, 0.2, u)
    got = _weave_u(outs, u, (2, u * 32, u * 1536))
    assert _maxdiff(got, _woven_cas(planes, u, u)) <= 1


def test_grid_parity_planes_p7_exotic_matches():
    """49-plane (p=7 exotic fraction) grid CAS matches the woven
    full-array evaluation."""
    u = 7
    rng = np.random.default_rng(55)
    v = rng.standard_normal((1, u * 64, u * 256)).astype(np.float32) * 0.6
    planes = [
        cas_ops.to_i16_storage(jnp.asarray(v[:, ry::u, rx::u]))
        for ry in range(u)
        for rx in range(u)
    ]
    outs = cas_parity_planes(planes, 0.2, u)
    got = _weave_u(outs, u, (1, u * 64, u * 256))
    assert _maxdiff(got, _woven_cas(planes, u, u)) <= 1


# ---------------------------------------------------------------------------
# plane CAS == woven CAS over the geometry / dtype / factor matrix
# ---------------------------------------------------------------------------

_GEOMS = {
    "aligned": (8, 128),   # 128-multiple plane width
    "nonaligned": (8, 50),
    "short_odd": (3, 21),  # fewer rows than any tile, odd everything
}


@pytest.mark.parametrize("sharpen", [0.0, 0.2])
@pytest.mark.parametrize("geom", sorted(_GEOMS))
@pytest.mark.parametrize("dtname", ["float32", "int16"])
@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_parity_planes_match_woven_cas(p, dtname, geom, sharpen):
    """cas_parity_planes on p x p planes == quantize_u8(cas_sharpen(.)) on
    the woven image built from the same stored planes."""
    h, w = _GEOMS[geom]
    rng = np.random.default_rng(1000 * p + h + w)
    v = rng.random((2, p * h, p * w)).astype(np.float32) * 1.3 - 0.1
    planes = [
        jnp.asarray(v[:, ry::p, rx::p]) for ry in range(p) for rx in range(p)
    ]
    if dtname == "int16":
        planes = [cas_ops.to_i16_storage(x) for x in planes]
    outs = cas_parity_planes(planes, sharpen, p)
    assert len(outs) == p * p
    assert all(o.shape == (2, h, w) and o.dtype == jnp.uint8 for o in outs)
    f = [np.asarray(cas_ops.clip_unit(x)) for x in planes]
    woven = np.zeros((2, p * h, p * w), np.float32)
    for i, x in enumerate(f):
        woven[:, i // p :: p, i % p :: p] = x
    want = np.asarray(
        cas_ops.quantize_u8(cas_ops.cas_sharpen(jnp.asarray(woven), sharpen))
    )
    assert _maxdiff(_weave_grid(outs, p, p), want) <= 1


def test_parity_planes_rejects_bad_plane_sets():
    x = jnp.zeros((1, 4, 4), jnp.float32)
    with pytest.raises(ValueError):
        cas_parity_planes([x] * 3, 0.2, 2)
    with pytest.raises(ValueError):
        cas_parity_planes([x, x, x, jnp.zeros((1, 4, 5))], 0.2, 2)


# ---------------------------------------------------------------------------
# the GPU kernel (ops/cas_triton.py): interpret mode, lowering, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom", [(16, 256), (21, 200), (3, 21)])
@pytest.mark.parametrize("dtname", ["float32", "int16"])
def test_triton_kernel_matches_plain_interpret(dtname, geom):
    """The Pallas Triton kernel (interpret mode) equals the plain plane
    CAS: aligned, ragged (masked last tiles) and shorter-than-a-tile
    planes, f32 and int16."""
    from vkresample_tpu.ops.cas_triton import cas_parity_planes_triton

    h, w = geom
    rng = np.random.default_rng(h * w)
    planes = [
        jnp.asarray(rng.random((2, h, w)).astype(np.float32) * 1.3 - 0.1)
        for _ in range(4)
    ]
    if dtname == "int16":
        planes = [cas_ops.to_i16_storage(p) for p in planes]
    want = cas_parity_planes(planes, 0.2, 2)
    got = cas_parity_planes_triton(planes, 0.2, 2, block=(8, 64), interpret=True)
    assert all(g.shape == (2, h, w) and g.dtype == jnp.uint8 for g in got)
    assert max(_maxdiff(g, x) for g, x in zip(got, want)) <= 1


def test_triton_kernel_lowers_for_cuda():
    """The kernel lowers through Pallas' Triton route for CUDA (no GPU
    needed to lower): catches primitives the route cannot express."""
    import jax

    from vkresample_tpu.ops.cas_triton import cas_parity_planes_triton

    for dt in (jnp.int16, jnp.float32):
        xs = jnp.zeros((4, 3, 40, 300), dt)
        f = jax.jit(lambda x: cas_parity_planes_triton(list(x), 0.2, 2))
        text = f.trace(xs).lower(lowering_platforms=("cuda",)).as_text()
        assert "triton" in text.lower()


def test_quad_cas_dispatch_off_cuda_is_plain():
    """cas_quad_planes runs the plain function wherever the program is not
    lowered for CUDA — here, the CPU — with identical pixels."""
    import jax

    from vkresample_tpu.ops.cas_triton import cas_quad_planes

    rng = np.random.default_rng(71)
    planes = [
        cas_ops.to_i16_storage(jnp.asarray(rng.random((3, 24, 136), np.float32)))
        for _ in range(4)
    ]
    got = jax.jit(lambda *p: cas_quad_planes(p, 0.2))(*planes)
    want = cas_parity_planes(planes, 0.2, 2)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
