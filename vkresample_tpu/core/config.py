"""Run configuration for the FFT upscaler.

Mirrors the capability surface of the reference's ``VkResampleConfiguration``
(/root/reference/VkResample.cpp:45-59) and its CLI defaults
(/root/reference/VkResample.cpp:1797-1804):

    upscale=1, precision=0, numIter=1, device_id=0, numThreads=1, sharpen=0.2

Precision modes (reference: VkResample.cpp:1329-1343, 1420-1422):
    0 - single:  fp32 storage + compute
    1 - double:  fp64 storage + compute
    2 - half:    half-precision *memory only* (uint8/low-precision at the
        device-memory boundary, fp32 compute).  The reference stores the
        staged input in IEEE fp16 and computes in fp32
        (``halfPrecisionMemoryOnly``, vkFFT.h:55); this build ingests raw
        uint8 (half the bytes of fp16), stores pre-CAS planes as int16
        Q2.14, and computes in fp32.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Precision(enum.IntEnum):
    """Numeric precision mode, flag-compatible with the reference ``-p``."""

    SINGLE = 0
    DOUBLE = 1
    HALF = 2  # memory-only half: low-precision storage, fp32 compute

    @property
    def compute_dtype(self):
        import jax.numpy as jnp

        if self is Precision.DOUBLE:
            return jnp.float64
        return jnp.float32

    @property
    def storage_dtype(self):
        """Pre-CAS intermediate storage dtype.  HALF stores int16 Q2.14
        fixed point (ops/cas.py) — same bytes as the reference's fp16
        storage, ~16x finer resolution on the CAS-clipped signal."""
        import jax.numpy as jnp

        if self is Precision.DOUBLE:
            return jnp.float64
        if self is Precision.HALF:
            return jnp.int16
        return jnp.float32

    @property
    def matmul_precision(self):
        """Dense-tier contraction precision per mode.

        SINGLE/DOUBLE use HIGHEST (full fp32 / fp64 products — the modes'
        own definition).  HALF uses the three-pass bf16 algorithm
        (BF16_BF16_F32_X3: hi/lo bf16 operand split, f32 accumulation).
        On an NVIDIA H100 (700 W) every HALF tier holds <= 1 uint8 LSB
        against the fp64 oracle at its timed size with it, where a single
        TF32 pass (Precision.HIGH on the GPU) does not: maxdiff 2 at the
        flagship f32-y arm and at -u 1.5, 3 at 8K->16K.  Among the
        candidates that hold the bound (BF16x3, TF32x3, HIGHEST) it is the
        fastest (PERF.md, Findings).
        Override with env VKRESAMPLE_MM_PRECISION=default|high|highest.
        """
        import os

        import jax

        ov = os.environ.get("VKRESAMPLE_MM_PRECISION")
        if ov:
            return {
                "default": jax.lax.Precision.DEFAULT,
                "high": jax.lax.Precision.HIGH,
                "highest": jax.lax.Precision.HIGHEST,
            }[ov.lower()]
        if self is Precision.HALF:
            return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
        return jax.lax.Precision.HIGHEST


class Engine(enum.Enum):
    """Which FFT execution tier to use.

    AUTO   - pick MXU tier when the plan supports it, else XLA.
    XLA    - jnp.fft (XLA's native FFT op).  Correct for any size; oracle-
             aligned reference tier.
    MXU    - matmul-form FFTs (dense, staged or mixed-radix) specialized
             at trace time (the analog of VkFFT's generated shaders,
             vkFFT.h:211-4642), with native frequency-domain
             zero-padding: padded bins are never computed or
             materialized.
    """

    AUTO = "auto"
    XLA = "xla"
    MXU = "mxu"


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Flag-level run configuration (reference: VkResample.cpp:45-59)."""

    upscale: float = 1.0  # -u
    precision: Precision = Precision.SINGLE  # -p
    num_iter: int = 1  # -n (dispatch-overhead-amortized timing)
    device_id: int = 0  # -d
    num_threads: int = 1  # -numthreads (PNG decode pool size)
    sharpen: float = 0.2  # -s
    input_path: Optional[str] = None  # -i
    output_path: Optional[str] = None  # -o
    ifolder_prefix: Optional[str] = None  # -ifolder
    ofolder_prefix: Optional[str] = None  # -ofolder
    num_files: int = 1  # -numfiles
    engine: Engine = Engine.AUTO

    @property
    def file_upload(self) -> bool:
        """Batched-folder mode (reference ``fileUpload``)."""
        return self.ifolder_prefix is not None


def default_output_name(w: int, upscale: float) -> str:
    """Default single-image output name (reference: VkResample.cpp:1706)."""
    return "%d_%d_upscaled.png" % (w, int(upscale * w))
