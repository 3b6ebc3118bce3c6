"""End-to-end XLA-tier pipeline vs the NumPy oracle, across precisions,
spectrum modes, and upscale factors (reference test strategy per SURVEY §4:
golden-oracle pixel-tolerance matching)."""
import numpy as np
import pytest

from conftest import make_test_image
from vkresample_tpu import Engine, Precision, UpscalePlan, upscale
from vkresample_tpu.oracle import numpy_ref as oracle


def _maxdiff(a, b):
    return int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))


@pytest.mark.parametrize("r2c", [True, False])
@pytest.mark.parametrize("u", [1.0, 2.0])
def test_xla_matches_oracle_fp32(u, r2c):
    img = make_test_image(64, 96, 3, seed=10)
    plan = UpscalePlan(h=64, w=96, upscale=u, r2c=r2c, engine=Engine.XLA)
    got = np.asarray(upscale(img, u, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert got.shape == want.shape
    assert _maxdiff(got, want) <= 1  # fp32 vs fp64 quantization boundary ties


def test_xla_matches_oracle_fp64():
    img = make_test_image(48, 64, 3, seed=11)
    plan = UpscalePlan(
        h=48, w=64, upscale=2.0, precision=Precision.DOUBLE, engine=Engine.XLA
    )
    got = np.asarray(upscale(img, 2.0, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert _maxdiff(got, want) == 0  # identical math in fp64


def test_xla_matches_oracle_half():
    img = make_test_image(64, 64, 3, seed=12)
    plan = UpscalePlan(
        h=64, w=64, upscale=2.0, precision=Precision.HALF, engine=Engine.XLA
    )
    got = np.asarray(upscale(img, 2.0, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    # half mode = uint8 ingest + fp32 compute: same tolerance as fp32
    assert _maxdiff(got, want) <= 1


def test_xla_fractional_upscale():
    img = make_test_image(64, 128, 3, seed=13)
    plan = UpscalePlan(h=64, w=128, upscale=1.5, engine=Engine.XLA)
    got = np.asarray(upscale(img, 1.5, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert got.shape == (96, 192, 3)
    assert _maxdiff(got, want) <= 1


def test_xla_odd_channel_counts_and_gray():
    img = make_test_image(32, 48, 1, seed=14)
    plan = UpscalePlan(h=32, w=48, upscale=2.0, channels=1, engine=Engine.XLA)
    got = np.asarray(upscale(img, 2.0, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert _maxdiff(got, want) <= 1


def test_xla_7smooth_mixed_radix_sizes():
    # 7-smooth non-pow2: 96=2^5*3, 2x -> 192; 140=2^2*5*7 -> 280
    img = make_test_image(96, 140, 3, seed=15)
    plan = UpscalePlan(h=96, w=140, upscale=2.0, engine=Engine.XLA)
    got = np.asarray(upscale(img, 2.0, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert _maxdiff(got, want) <= 1


def test_rejects_non_uint8():
    with pytest.raises(TypeError):
        upscale(np.zeros((8, 8, 3), np.float32), 2.0)


def test_odd_height_u1_matches_oracle():
    img = make_test_image(33, 48, 3, seed=16)
    plan = UpscalePlan(h=33, w=48, upscale=1.0, engine=Engine.XLA)
    got = np.asarray(upscale(img, 1.0, plan=plan))
    want = oracle.upscale_oracle(img, plan)
    assert _maxdiff(got, want) <= 1


def test_planes_out_matches_woven():
    """planes_out returns (E, D) parity planes equal to the woven output's
    even/odd rows (w=64 takes the rows-parity route)."""
    import functools

    import jax
    from jax import numpy as jnp

    from vkresample_tpu.core.config import Engine, Precision
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.pipeline.upscale import _pipeline, make_device_banks

    plan = UpscalePlan(h=32, w=64, upscale=2.0, precision=Precision.HALF,
                       engine=Engine.MXU)
    engine = plan.resolve_engine()
    banks = make_device_banks(plan, engine)
    img = np.random.default_rng(61).integers(0, 256, (32, 64, 3), np.uint8)
    woven = np.asarray(
        jax.jit(functools.partial(_pipeline, plan=plan, engine=engine,
                                  planar_out=True))(jnp.asarray(img), banks)
    )
    E, D = jax.jit(functools.partial(_pipeline, plan=plan, engine=engine,
                                     planes_out=True))(jnp.asarray(img), banks)
    np.testing.assert_array_equal(np.asarray(E), woven[:, 0::2, :])
    np.testing.assert_array_equal(np.asarray(D), woven[:, 1::2, :])


def test_planes_out_quad_matches_woven():
    """Route formats depend on the plan alone: a 128-aligned u=2 plan
    reports 'quad' on every platform, and _pipeline's plane output has
    the quad layout and equals the woven output.  The parity CAS math
    itself is oracle-tested in test_cas_pallas."""
    import functools

    import jax
    from jax import numpy as jnp

    from vkresample_tpu.core.config import Engine, Precision
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.pipeline.upscale import (
        _parity_route,
        _pipeline,
        make_device_banks,
        planes_format,
    )

    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF,
                       engine=Engine.MXU)
    assert _parity_route(plan) == "quad"  # geometry says quad
    assert planes_format(plan) == "quad"  # and so does the route
    banks = make_device_banks(plan, Engine.MXU)
    img = np.random.default_rng(62).integers(0, 256, (32, 128, 3), np.uint8)
    run = lambda po: jax.jit(functools.partial(  # noqa: E731
        _pipeline, plan=plan, engine=Engine.MXU, planar_out=True,
        planes_out=po))(jnp.asarray(img), banks)
    outs = run(True)
    assert len(outs) == 4 and all(o.shape == (3, 32, 128) for o in outs)
    # woven callers take the rows route (another transform arm), so the
    # two agree to the oracle's tolerance rather than bit for bit
    woven = np.asarray(run(False))
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert _maxdiff(woven, want) <= 1
    for i, o in enumerate(outs):
        assert _maxdiff(np.asarray(o), want[:, i // 2::2, i % 2::2]) <= 1
    # DOUBLE stays woven
    plan_d = UpscalePlan(h=32, w=128, upscale=2.0,
                         precision=Precision.DOUBLE, engine=Engine.MXU)
    assert planes_format(plan_d) is None

    # odd-width geometry falls back to the rows formulation
    plan2 = UpscalePlan(h=32, w=96, upscale=2.0, engine=Engine.MXU)
    assert _parity_route(plan2) == "rows"
    # non-u2 has no parity route at all
    plan3 = UpscalePlan(h=32, w=128, upscale=3.0, engine=Engine.MXU)
    assert _parity_route(plan3) is None


def test_pipeline_big_quad_banks_route(monkeypatch):
    """_pipeline's big int8-only bank gating (use_big_quad): with
    parity-plane output and the i16 codec, the int8-only bank set drives
    the quad branch and the woven result matches the oracle."""
    import functools

    import jax
    from jax import numpy as jnp

    from vkresample_tpu.core.config import Engine, Precision
    from vkresample_tpu.core.plan import UpscalePlan
    from vkresample_tpu.fft import dense
    from vkresample_tpu.oracle import numpy_ref as oracle
    from vkresample_tpu.pipeline import upscale as up

    plan = UpscalePlan(h=32, w=128, upscale=2.0, precision=Precision.HALF,
                       engine=Engine.MXU)
    banks = jax.device_put(dense.r2c_quad_int8_banks(plan))
    img = np.random.default_rng(77).integers(0, 256, (32, 128, 3), np.uint8)
    outs = jax.jit(
        functools.partial(up._pipeline, plan=plan, engine=Engine.MXU,
                          planar_out=True, planes_out=True)
    )(jnp.asarray(img), banks)
    got = np.zeros((3, 64, 256), np.uint8)
    got[:, 0::2, 0::2] = np.asarray(outs[0])
    got[:, 0::2, 1::2] = np.asarray(outs[1])
    got[:, 1::2, 0::2] = np.asarray(outs[2])
    got[:, 1::2, 1::2] = np.asarray(outs[3])
    want = np.moveaxis(oracle.upscale_oracle(img, plan), -1, 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
