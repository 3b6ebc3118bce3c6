"""Parity-plane CAS + quantize as a Pallas kernel on the Triton route.

One block per (channel, row band, column band).  Each block loads its
tile of every parity plane at the plane offsets the stencil needs (one
row and one column of halo, index-clamped, so every load is in bounds),
evaluates ops/cas.py's parity_stencil on them, and writes one uint8 tile
per plane under a mask.  Nothing carries over between blocks.

The arithmetic is ops.cas.parity_stencil itself, so the kernel and
cas_parity_planes (the plain function XLA compiles) agree bit for bit;
only the tiling differs.  Why a kernel at all: for the four quad planes
XLA emits 14 fusions that read ~1.3 GB at the flagship plane size, where
one pass needs 75 MB; the kernel reads each tile once (plus halo, from
cache): on an NVIDIA H100 the CAS alone took 3.6x (flagship planes) and
2.1x (8K planes) less time, and the whole frame 30% (flagship) and 41%
(8K->16K) less (PERF.md, Findings).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .cas import cas_parity_planes, clip_unit, parity_stencil

# tile (rows, columns) and warp count: the fastest of seven tiles from
# 8x128 to 64x64, each with 4 and 8 warps, at both the flagship and the
# 8K plane sizes on an NVIDIA H100 (400 W; PERF.md lists the sweep).  The
# kernel has no loop, so Triton's num_stages has nothing to pipeline.
QUAD_BLOCK = (8, 128)
QUAD_WARPS = 8


def _kernel(*refs, uy, ux, h, w, bh, bw, sharpen):
    n = uy * ux
    ins, outs = refs[:n], refs[n:]
    c = pl.program_id(0)
    i = pl.program_id(1)
    j = pl.program_id(2)
    r = i * bh + jnp.arange(bh)
    q = j * bw + jnp.arange(bw)

    def tap(ry, rx, dy, dx):
        ri = jnp.clip(r + dy, 0, h - 1)
        qi = jnp.clip(q + dx, 0, w - 1)
        return clip_unit(ins[ry * ux + rx][c, ri[:, None], qi[None, :]])

    edges = (
        (r == 0)[:, None], (r == h - 1)[:, None],
        (q == 0)[None, :], (q == w - 1)[None, :],
    )
    mask = (r < h)[:, None] & (q < w)[None, :]
    for o_ref, o in zip(outs, parity_stencil(tap, uy, ux, sharpen, edges)):
        plgpu.store(
            o_ref.at[c, pl.ds(i * bh, bh), pl.ds(j * bw, bw)], o, mask=mask
        )


def cas_parity_planes_triton(
    planes, sharpen: float, uy: int, ux: int = None, block=QUAD_BLOCK,
    num_warps: int = QUAD_WARPS, interpret: bool = False,
):
    """Same contract as ops.cas.cas_parity_planes.  block = (rows,
    columns) of one tile, both powers of two."""
    ux = uy if ux is None else ux
    n = uy * ux
    if len(planes) != n or any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"expected {n} parity planes of one shape")
    lead = planes[0].shape[:-2]
    ps = [p.reshape((-1,) + p.shape[-2:]) for p in planes]
    C, h, w = ps[0].shape
    bh, bw = block
    kern = functools.partial(
        _kernel, uy=uy, ux=ux, h=h, w=w, bh=bh, bw=bw, sharpen=float(sharpen)
    )
    outs = pl.pallas_call(
        kern,
        out_shape=tuple(
            jax.ShapeDtypeStruct((C, h, w), jnp.uint8) for _ in range(n)
        ),
        grid=(C, pl.cdiv(h, bh), pl.cdiv(w, bw)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="cas_parity_planes",
    )(*ps)
    return tuple(o.reshape(lead + (h, w)) for o in outs)


def cas_quad_planes(planes, sharpen: float):
    """Quad-parity (2 x 2) CAS + quantize: the Triton kernel where the
    program is lowered for CUDA, ops.cas.cas_parity_planes (the same
    arithmetic, bit for bit) everywhere else."""
    planes = tuple(planes)
    return tuple(jax.lax.platform_dependent(
        *planes,
        cuda=lambda *p: cas_parity_planes_triton(p, sharpen, 2),
        default=lambda *p: cas_parity_planes(p, sharpen, 2),
    ))
