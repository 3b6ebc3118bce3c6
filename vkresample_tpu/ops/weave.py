"""Device-side u8 parity weaves, for callers that want the woven image
on the device (the library upscale() API); the PNG path never weaves.

Column interleaves pack the two column-parity bytes into ONE uint16
element (even | odd << 8) and bitcast u16 -> u8: the interleave is
integer arithmetic, and the trailing (w, 2) -> 2w reshape after the
bitcast is minor-most.  Row weaves are a stack + reshape.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def weave_cols_u8(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    """(..., h, w) + (..., h, w) uint8 -> (..., h, 2w) uint8 with
    out[..., 0::2] = even, out[..., 1::2] = odd."""
    if even.dtype != jnp.uint8 or odd.dtype != jnp.uint8:
        raise TypeError("weave_cols_u8 expects uint8 planes")
    w16 = even.astype(jnp.uint16) | (odd.astype(jnp.uint16) << 8)
    pair = jax.lax.bitcast_convert_type(w16, jnp.uint8)  # (..., h, w, 2)
    # little-endian byte order: byte 0 = low byte = even column
    return pair.reshape(pair.shape[:-2] + (2 * pair.shape[-2],))


def weave_rows_u8(top: jnp.ndarray, bot: jnp.ndarray) -> jnp.ndarray:
    """(..., h, W) + (..., h, W) -> (..., 2h, W): row interleave."""
    out = jnp.stack([top, bot], axis=-2)
    return out.reshape(out.shape[:-3] + (2 * out.shape[-3], out.shape[-1]))


def weave_quad_u8(P00, P01, P10, P11) -> jnp.ndarray:
    """Four uint8 quad-parity planes (..., h, w), p[row parity][col
    parity], -> woven (..., 2h, 2w) uint8."""
    return weave_rows_u8(weave_cols_u8(P00, P01), weave_cols_u8(P10, P11))


def _weave_cols_n_u8(cols):
    """Column interleave of n uint8 planes: out[..., i::n] = cols[i].
    Power-of-two n rides the recursive u16 lane-pack (interleave of the
    even-indexed weave with the odd-indexed weave); other n fall back to
    the stack+reshape layout op."""
    n = len(cols)
    if n == 1:
        return cols[0]
    if n % 2 == 0:
        return weave_cols_u8(
            _weave_cols_n_u8(cols[0::2]), _weave_cols_n_u8(cols[1::2])
        )
    out = jnp.stack(cols, axis=-1)
    return out.reshape(out.shape[:-2] + (n * out.shape[-2],))


def weave_grid_u8(planes, u: int) -> jnp.ndarray:
    """u*u uint8 grid-parity planes (row-major (ry, rx), each (..., h, w))
    -> woven (..., u*h, u*w) uint8.  Row interleave is a
    stack; columns take _weave_cols_n_u8."""
    rows = [
        _weave_cols_n_u8(list(planes[ry * u : (ry + 1) * u]))
        for ry in range(u)
    ]
    out = jnp.stack(rows, axis=-2)
    return out.reshape(out.shape[:-3] + (u * out.shape[-3], out.shape[-1]))
