"""Complex arithmetic over explicit (re, im) float pairs.

Representing complex tensors as two real arrays lets every complex
matmul lower to real matmuls (3 per complex product via Karatsuba with
precomputed matrix sums) and keeps layouts fully under our control — the
analog of VkFFT generating
scalar-pair arithmetic in its shaders (vkFFT.h:731-1182 butterflies).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

CPair = Tuple[jnp.ndarray, jnp.ndarray]


def cmul(a: CPair, b: CPair) -> CPair:
    """Elementwise complex multiply (4 real mults — VPU, cheap)."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def to_pair(z) -> CPair:
    """numpy/jax complex array -> (re, im) pair."""
    return jnp.real(z), jnp.imag(z)


def to_complex(a: CPair):
    import jax.lax

    return jax.lax.complex(a[0], a[1])
