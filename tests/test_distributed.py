"""Pencil-decomposed distributed upscale over the virtual 8-device mesh:
output must match the single-device pipeline exactly (same math, different
layout + collectives)."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from conftest import make_test_image
from vkresample_tpu import Engine, UpscalePlan, upscale
from vkresample_tpu.parallel.distributed import build_sp_upscale


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("sp",))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("u", [1.0, 2.0])
def test_sp_matches_single_device(n_shards, u):
    h, w = 64, 96
    img = make_test_image(h, w, 3, seed=50)
    plan = UpscalePlan(h=h, w=w, upscale=u, engine=Engine.MXU)
    mesh = _mesh(n_shards)
    fn = build_sp_upscale(plan, mesh)
    got = np.asarray(fn(img))
    want = np.asarray(upscale(img, u, plan=plan))
    # different fusion/reassociation across program structures flips
    # quantization ties -> standard <=1 u8 LSB tolerance
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sp_rejects_bad_shard_count():
    plan = UpscalePlan(h=36, w=64, upscale=2.0, engine=Engine.MXU)
    with pytest.raises(ValueError, match="shards"):
        build_sp_upscale(plan, _mesh(8))  # 36 rows can't split into 16 pairs


def test_sp_rejects_fractional():
    plan = UpscalePlan(h=64, w=96, upscale=1.5)
    with pytest.raises(ValueError, match="integer"):
        build_sp_upscale(plan, _mesh(2))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sp_dense_matches_single_device(n_shards):
    from vkresample_tpu.parallel.distributed import build_sp_upscale_dense

    h, w = 64, 64  # W = 128 divides by 8
    img = make_test_image(h, w, 3, seed=51)
    plan = UpscalePlan(h=h, w=w, upscale=2.0, engine=Engine.MXU)
    fn = build_sp_upscale_dense(plan, _mesh(n_shards))
    got = np.asarray(fn(img))
    want = np.asarray(upscale(img, 2.0, plan=plan))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sp_dense_rejects_fractional():
    from vkresample_tpu.parallel.distributed import build_sp_upscale_dense

    plan = UpscalePlan(h=64, w=64, upscale=1.5)
    with pytest.raises(ValueError, match="integer"):
        build_sp_upscale_dense(plan, _mesh(2))


def test_sp_large_geometry_vs_oracle():
    """Large-frame pencil run on the full 8-device mesh:
    1024x2048 -> 2048x4096 half mode through BOTH sp pipelines, pixel-equal
    to the fp64 oracle within 1 LSB.  Stresses the all-to-all layout math
    and the kpad column padding (w/2+1 = 1025 pads to 1032 for S=8)."""
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.oracle import numpy_ref as oracle
    from vkresample_tpu.parallel.distributed import build_sp_upscale_dense

    h, w = 1024, 2048
    img = make_test_image(h, w, 3, seed=52)
    plan = UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    want = oracle.upscale_oracle(img, plan)
    mesh = _mesh(8)
    for builder in (build_sp_upscale_dense, build_sp_upscale):
        got = np.asarray(builder(plan, mesh)(img))
        assert got.shape == want.shape, builder.__name__
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= 1, (builder.__name__, diff)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sp_staged_matches_single_device(n_shards):
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.parallel.distributed import build_sp_upscale_staged

    h, w = 64, 256  # staged route needs w % 128 == 0 + usable splits
    img = make_test_image(h, w, 3, seed=53)
    plan = UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    fn = build_sp_upscale_staged(plan, _mesh(n_shards))
    got = np.asarray(fn(img))
    want = np.asarray(upscale(img, 2.0, plan=plan))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sp_staged_rejects_fractional_and_bad_shards():
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.parallel.distributed import build_sp_upscale_staged

    plan = UpscalePlan(h=64, w=256, upscale=1.5, precision=Precision.HALF)
    with pytest.raises(ValueError, match="u=2"):
        build_sp_upscale_staged(plan, _mesh(2))
    plan = UpscalePlan(
        h=36, w=256, upscale=2.0, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    with pytest.raises(ValueError, match="shards"):
        build_sp_upscale_staged(plan, _mesh(8))


def test_sp_staged_large_geometry_vs_oracle():
    """Large-frame STAGED pencil run on the full 8-device mesh:
    1024x2048 -> 2048x4096 half through the staged sp pipeline (O(n*n1)
    banks — the any-size cross-chip tier), pixel-equal to the fp64
    oracle within 1 LSB."""
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.oracle import numpy_ref as oracle
    from vkresample_tpu.parallel.distributed import build_sp_upscale_staged

    h, w = 1024, 2048
    img = make_test_image(h, w, 3, seed=54)
    plan = UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )
    want = oracle.upscale_oracle(img, plan)
    got = np.asarray(build_sp_upscale_staged(plan, _mesh(8))(img))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("u", [3.0, 1.5])
def test_sp_grid_matches_single_device(n_shards, u):
    """Grid staged pencil (u-generic, integer or fractional) matches the
    single-device pipeline."""
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.parallel.distributed import build_sp_upscale_grid

    h, w = 64, 256
    img = make_test_image(h, w, 3, seed=55)
    plan = UpscalePlan(
        h=h, w=w, upscale=u, precision=Precision.HALF, engine=Engine.MXU
    )
    fn = build_sp_upscale_grid(plan, _mesh(n_shards))
    got = np.asarray(fn(img))
    want = np.asarray(upscale(img, u, plan=plan))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sp_grid_rejects():
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.parallel.distributed import build_sp_upscale_grid

    # c2c plans are not the r2c grid form
    plan = UpscalePlan(
        h=64, w=256, upscale=2.0, r2c=False, precision=Precision.HALF
    )
    with pytest.raises(ValueError, match="r2c"):
        build_sp_upscale_grid(plan, _mesh(2))
    # rows don't split across shards
    plan = UpscalePlan(
        h=36, w=256, upscale=3.0, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    with pytest.raises(ValueError, match="shards"):
        build_sp_upscale_grid(plan, _mesh(8))


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("u", [2.0, 1.5])
def test_sp_c2c_grid_matches_oracle(n_shards, u):
    """c2c grid staged pencil matches the fp64 oracle (the single-device
    c2c route at these sizes is the dense chain, so compare to the
    oracle directly)."""
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.oracle import numpy_ref as oracle
    from vkresample_tpu.parallel.distributed import build_sp_upscale_c2c_grid

    h, w = 64, 256
    img = make_test_image(h, w, 3, seed=56)
    plan = UpscalePlan(
        h=h, w=w, upscale=u, r2c=False, precision=Precision.HALF,
        engine=Engine.MXU,
    )
    fn = build_sp_upscale_c2c_grid(plan, _mesh(n_shards))
    got = np.asarray(fn(img))
    want = oracle.upscale_oracle(img, plan)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sp_c2c_grid_rejects_r2c():
    from vkresample_tpu.core.config import Precision
    from vkresample_tpu.parallel.distributed import build_sp_upscale_c2c_grid

    plan = UpscalePlan(h=64, w=256, upscale=2.0, precision=Precision.HALF)
    with pytest.raises(ValueError, match="c2c"):
        build_sp_upscale_c2c_grid(plan, _mesh(2))
