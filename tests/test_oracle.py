"""Oracle self-consistency: mathematical properties the pipeline must have.

These tests validate the NumPy oracle itself (the ground truth everything
else is compared against), using analytically-known cases.
"""
import numpy as np
import pytest

from conftest import make_test_image
from vkresample_tpu.core.plan import UpscalePlan
from vkresample_tpu.oracle import numpy_ref as oracle


def _pre_cas_upscale(img_ch, plan):
    """Spectral upscale of one channel without CAS (u^2-normalized)."""
    f = img_ch.astype(np.float64) / 255.0
    u2 = float(np.float32(plan.upscale)) ** 2
    if plan.r2c:
        F = np.fft.rfft2(f)
        G = oracle.assemble_big_spectrum(F, plan)
        return u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    F = np.fft.fft2(f)
    G = oracle.assemble_big_spectrum(F, plan)
    return u2 * np.fft.ifft2(G)


def test_constant_image_stays_constant():
    img = np.full((64, 96, 3), 128, np.uint8)
    plan = UpscalePlan(h=64, w=96, upscale=2.0, sharpen=0.2)
    out = oracle.upscale_oracle(img, plan)
    assert out.shape == (128, 192, 3)
    # flat image: CAS is a no-op on constants; value preserved up to
    # FFT-roundtrip noise at the truncation boundary
    assert np.max(np.abs(out.astype(int) - 128)) <= 1


@pytest.mark.parametrize("r2c", [True, False])
def test_lowfreq_sinusoid_exact_interpolation(r2c):
    """A band-limited signal (freqs < n/2) upscales to the *exact* sinusoid
    sampled on the fine grid — the defining property of sinc interpolation."""
    h, w, u = 64, 128, 2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = 0.5 + 0.2 * np.sin(2 * np.pi * 5 * xx / w) + 0.1 * np.cos(2 * np.pi * 3 * yy / h)
    img_ch = f  # keep float; bypass quantization for exactness
    plan = UpscalePlan(h=h, w=w, upscale=float(u), r2c=r2c)

    # run the spectral core on the float directly
    u2 = float(u) ** 2
    if r2c:
        F = np.fft.rfft2(f)
        G = oracle.assemble_big_spectrum(F, plan)
        out = u2 * np.fft.irfft2(G, s=(plan.H, plan.W))
    else:
        F = np.fft.fft2(f)
        G = oracle.assemble_big_spectrum(F, plan)
        out = np.real(u2 * np.fft.ifft2(G))

    YY, XX = np.mgrid[0 : plan.H, 0 : plan.W].astype(np.float64)
    expected = (
        0.5
        + 0.2 * np.sin(2 * np.pi * 5 * XX / plan.W)
        + 0.1 * np.cos(2 * np.pi * 3 * YY / plan.H)
    )
    np.testing.assert_allclose(out, expected, atol=1e-12)
    del img_ch


def test_upscale_preserves_source_samples_u2():
    """For 2x upscale of a band-limited-enough image, out[2i, 2j] ~ in[i, j]
    up to the dropped Nyquist band energy (small for natural images)."""
    img = make_test_image(64, 64, 1, seed=3)
    plan = UpscalePlan(h=64, w=64, upscale=2.0)
    pre = _pre_cas_upscale(img[:, :, 0], plan)
    src = img[:, :, 0].astype(np.float64) / 255.0
    err = np.abs(pre[::2, ::2] - src)
    assert np.median(err) < 0.02


def test_identity_upscale_is_cas_only():
    img = make_test_image(48, 80, 3, seed=1)
    plan = UpscalePlan(h=48, w=80, upscale=1.0, sharpen=0.2)
    out = oracle.upscale_oracle(img, plan)
    # u=1: spectrum roundtrip is identity (all bins kept), so output is
    # CAS(img/255) quantized
    ref = np.empty_like(out)
    for ch in range(3):
        f = img[:, :, ch].astype(np.float64) / 255.0
        ref[:, :, ch] = oracle.quantize_u8(
            oracle.cas_sharpen(f, 0.2)
        )
    # FFT roundtrip introduces ~1e-15 noise; truncation at integer
    # boundaries can tie-break differently -> allow off-by-one
    assert np.max(np.abs(out.astype(int) - ref.astype(int))) <= 1


def test_sharpen_zero_is_clamped_passthrough():
    img = make_test_image(32, 64, 1, seed=2)
    plan = UpscalePlan(h=32, w=64, upscale=1.0, sharpen=0.0)
    out = oracle.upscale_oracle(img, plan)
    # s=0 -> scale=0 -> out = clamped |value|: identity up to FFT-roundtrip
    # noise tie-breaking at the truncation boundary
    assert np.max(np.abs(out[:, :, 0].astype(int) - img[:, :, 0].astype(int))) <= 1


def test_r2c_vs_c2c_nearly_agree():
    """The two spectrum modes differ only in Nyquist-bin bookkeeping; on a
    band-limited image they must produce nearly identical pixels."""
    img = make_test_image(64, 96, 3, seed=4)
    p_r2c = UpscalePlan(h=64, w=96, upscale=2.0, r2c=True)
    p_c2c = UpscalePlan(h=64, w=96, upscale=2.0, r2c=False)
    a = oracle.upscale_oracle_float(img, p_r2c)
    b = oracle.upscale_oracle_float(img, p_c2c)
    assert np.max(np.abs(a - b)) < 0.05
    assert np.mean(np.abs(a - b)) < 0.005


def test_fractional_upscale_shapes_and_flatness():
    img = np.full((64, 128, 3), 200, np.uint8)
    plan = UpscalePlan(h=64, w=128, upscale=1.5)
    out = oracle.upscale_oracle(img, plan)
    assert out.shape == (96, 192, 3)
    assert np.max(np.abs(out.astype(int) - 200)) <= 1
