"""vkresample_tpu — FFT-based real-time image upscaler on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of DTolm/VkResample
(real-time frequency-domain upscaling + FidelityFX-CAS sharpening):
matmul-form FFTs, trace-time specialization, uint8 device boundaries,
parity-plane CAS whose planes the PNG encoder weaves, and frame sharding
over device meshes.

Public API:
    upscale(img, upscale, precision=..., sharpen=...) -> uint8 image
    UpscalePlan — static plan (the analog of VkFFTConfiguration + init)
    Precision, Engine, ResampleConfig
    build_batched_upscale / upscale_batch — frames sharded over a dp mesh
    build_sp_upscale* — one frame pencil-decomposed over an sp mesh
"""

__version__ = "0.1.0"

from .core.config import Engine, Precision, ResampleConfig  # noqa: F401
from .core.plan import UpscalePlan, output_dims  # noqa: F401
from .core.smooth import factorize_7smooth, is_7smooth, plan_factors  # noqa: F401
from .ops.convolve import fft_convolve2d, fft_matrix_convolve2d  # noqa: F401
from .parallel.distributed import (  # noqa: F401
    build_sp_upscale,
    build_sp_upscale_c2c_grid,
    build_sp_upscale_dense,
    build_sp_upscale_grid,
    build_sp_upscale_staged,
)
from .pipeline.batched import build_batched_upscale, upscale_batch  # noqa: F401
from .pipeline.upscale import build_upscale, upscale  # noqa: F401
