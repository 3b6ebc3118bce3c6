"""Disk bank cache (core/bankcache.py): round-trip fidelity (incl.
bfloat16/int8/0-d leaves), hit/miss behavior, knob keying, corruption
fallback, and the make_dense_banks integration."""
import numpy as np
import pytest

import ml_dtypes

from vkresample_tpu.core import bankcache
from vkresample_tpu.core.config import Engine, Precision
from vkresample_tpu.core.plan import UpscalePlan


@pytest.fixture()
def cachedir(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bankcache, "MIN_CACHED_DIM", 0)
    return tmp_path


def _plan(h=32, w=64):
    return UpscalePlan(
        h=h, w=w, upscale=2.0, precision=Precision.HALF, engine=Engine.MXU
    )


SAMPLE = {
    "f32": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
    "f64": np.linspace(-1, 1, 8, dtype=np.float64),
    "i8": np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
    "bf16": np.linspace(-2, 2, 16).astype(ml_dtypes.bfloat16),
    "scalar": np.float32(0.25),
}


def test_round_trip_and_hit(cachedir):
    calls = []

    def build():
        calls.append(1)
        return dict(SAMPLE)

    got1 = bankcache.get_or_build("t", _plan(), "float32", build)
    got2 = bankcache.get_or_build("t", _plan(), "float32", build)
    assert len(calls) == 1  # second call served from disk
    for k, v in SAMPLE.items():
        for got in (got1, got2):
            a = np.asarray(got[k])
            assert a.dtype == np.asarray(v).dtype, k
            assert np.array_equal(
                a.view(np.uint8 if a.dtype.itemsize == 1 else a.dtype),
                np.asarray(v).view(
                    np.uint8 if a.dtype.itemsize == 1 else a.dtype
                ),
            ), k


def test_key_separates_geometry_and_knobs(cachedir, monkeypatch):
    calls = []

    def build():
        calls.append(1)
        return {"x": np.zeros(2, np.float32)}

    bankcache.get_or_build("t", _plan(32, 64), "float32", build)
    bankcache.get_or_build("t", _plan(32, 128), "float32", build)
    bankcache.get_or_build("u", _plan(32, 64), "float32", build)
    monkeypatch.setenv("VKRESAMPLE_MM_PRECISION", "highest")
    bankcache.get_or_build("t", _plan(32, 64), "float32", build)
    assert len(calls) == 4  # every variation missed


def test_corrupt_entry_rebuilds(cachedir):
    def build():
        return {"x": np.arange(4, dtype=np.float32)}

    bankcache.get_or_build("t", _plan(), "float32", build)
    (entry,) = cachedir.glob("t-*.npz")
    entry.write_bytes(b"not a zip")
    got = bankcache.get_or_build("t", _plan(), "float32", build)
    assert np.array_equal(got["x"], np.arange(4, dtype=np.float32))


def test_disable_env(cachedir, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_NO_BANK_CACHE", "1")
    bankcache.get_or_build(
        "t", _plan(), "float32", lambda: {"x": np.zeros(1, np.float32)}
    )
    assert not list(cachedir.glob("*.npz"))


def test_small_geometry_skips_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("VKRESAMPLE_CACHE_DIR", str(tmp_path))
    # MIN_CACHED_DIM untouched (4096): a 32x64 plan must not hit disk
    bankcache.get_or_build(
        "t", _plan(), "float32", lambda: {"x": np.zeros(1, np.float32)}
    )
    assert not list(tmp_path.glob("*.npz"))


def test_make_dense_banks_via_cache(cachedir):
    """make_dense_banks round-trips the real rows bank set through the
    cache with every leaf equal (incl. split-bf16 and int8 digit banks)."""
    from vkresample_tpu.fft import mxu_pipeline

    plan = _plan(64, 256)
    fresh = mxu_pipeline.make_dense_banks(plan, "float32")
    cached = mxu_pipeline.make_dense_banks(plan, "float32")
    assert list(cachedir.glob("rows-*.npz"))
    assert set(fresh) == set(cached)
    for k in fresh:
        a, b = np.asarray(fresh[k]), np.asarray(cached[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(
            a.view(np.uint16 if a.dtype.name == "bfloat16" else a.dtype),
            b.view(np.uint16 if a.dtype.name == "bfloat16" else a.dtype),
        ), k


def test_compilation_cache_config(cachedir, monkeypatch):
    """enable_compilation_cache points jax's persistent executable cache
    at $VKRESAMPLE_CACHE_DIR/xla, and the opt-out env leaves the config
    untouched."""
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("VKRESAMPLE_NO_COMPILE_CACHE", "1")
        bankcache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == prev

        monkeypatch.delenv("VKRESAMPLE_NO_COMPILE_CACHE")
        bankcache.enable_compilation_cache()
        import os

        want = os.path.join(str(cachedir), "xla")
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compilation_cache_follows_env_dir(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, jax owns the cache location and
    the code sets no directory at all."""
    import jax

    monkeypatch.delenv("VKRESAMPLE_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    prev = jax.config.jax_compilation_cache_dir
    try:
        bankcache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == prev
        assert not (tmp_path / "jc").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compilation_cache_default_in_checkout(monkeypatch):
    """Without either env var the cache sits at one fixed path inside the
    checkout (never $HOME, a temp name, a pid or the time), and git
    ignores it."""
    import os
    import pathlib

    import jax

    monkeypatch.delenv("VKRESAMPLE_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("VKRESAMPLE_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parent.parent
    prev = jax.config.jax_compilation_cache_dir
    try:
        bankcache.enable_compilation_cache()
        got = jax.config.jax_compilation_cache_dir
        assert got == os.path.join(str(repo), ".cache", "xla")
        bankcache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == got  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    ignored = (repo / ".gitignore").read_text().split()
    assert ".cache/" in ignored
