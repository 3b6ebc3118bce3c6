"""Pencil-decomposed distributed upscale: one frame sharded across chips.

The reference has no distributed mode (SURVEY §2.4) — its long-sequence
mechanism is the multi-upload 4-step FFT within one GPU (vkFFT.h:4733-4771).
Here the analogous capability *across devices* is a pencil decomposition
over an 'sp' mesh axis: rows of the frame live on different devices, FFT
passes run locally, and a single all-to-all re-pencils between the x and
y passes (NCCL over NVLink between the GPUs of one host).  This serves
frames too large for one device's memory (e.g. 16K x 8K).

Layout walk (S = shard count, per-chip shapes):
  input   (C, h/S, w)   rows sharded
  x-FFT   local (row-pair packed R2C)        -> (C, h/S, w/2+1)
  A2A     re-pencil to columns sharded       -> (C, h, (w/2+1)/S)*
  y-FFT   local over full h                  -> small spectrum, cols sharded
  y-phase inverse local                      -> (C, h, K/S) per phase
  A2A     back to rows sharded               -> (C, h/S, K) per phase
  x-phase C2R local, interleave              -> (C, u*h/S, u*w)
  CAS     with 1-row halo exchange (ppermute)-> output rows block per chip

(*) the half-spectrum column count w/2+1 is padded to w/2+S columns so it
splits evenly; the pad columns are zero and ignored.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.plan import UpscalePlan
from ..fft.mixed_radix import fft
from ..fft.rfft2 import (
    _c2r_rows_packed,
    _mul_row_twiddle,
    _phase_twiddle_x_r2c,
    _phase_twiddle_y,
    rfft2_packed,
)
from ..ops import cas as cas_ops


def _halo_rows(x: jnp.ndarray, axis_name: str):
    """Exchange one edge row with ring neighbors along `axis_name`;
    returns (row_above, row_below) with edge clamping at the ends
    (CAS clamp-to-edge semantics, VkResample.cpp:889-892)."""
    s = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top = x[..., :1, :]
    bot = x[..., -1:, :]
    # from_prev[i] = bot of shard i-1 ; from_next[i] = top of shard i+1
    from_prev = jax.lax.ppermute(
        bot, axis_name, [(i, (i + 1) % s) for i in range(s)]
    )
    from_next = jax.lax.ppermute(
        top, axis_name, [(i, (i - 1) % s) for i in range(s)]
    )
    # clamp at global edges: first shard's "above" is its own top row,
    # last shard's "below" is its own bottom row
    above = jnp.where(idx == 0, top, from_prev)
    below = jnp.where(idx == s - 1, bot, from_next)
    return above, below


def _cas_sharded(v: jnp.ndarray, sharpen: float, axis_name: str) -> jnp.ndarray:
    """CAS over row-sharded (..., rows, W) with halo rows from neighbors."""
    above, below = _halo_rows(v, axis_name)
    vpad = jnp.concatenate([above, v, below], axis=-2)
    # cas_sharpen edge-pads; rows already haloed, so pad only x then crop y
    ln = jnp.clip(jnp.abs(vpad), 0.0, 1.0)
    p = jnp.pad(ln, [(0, 0)] * (ln.ndim - 1) + [(1, 1)], mode="edge")
    c = p[..., 1:-1, 1:-1]
    n = p[..., :-2, 1:-1]
    s_ = p[..., 2:, 1:-1]
    w_ = p[..., 1:-1, :-2]
    e = p[..., 1:-1, 2:]
    nw = p[..., :-2, :-2]
    ne = p[..., :-2, 2:]
    sw = p[..., 2:, :-2]
    se = p[..., 2:, 2:]
    min_cross = jnp.minimum(n, jnp.minimum(w_, jnp.minimum(c, jnp.minimum(e, s_))))
    min_all = jnp.minimum(min_cross, jnp.minimum(nw, jnp.minimum(ne, jnp.minimum(sw, se))))
    max_cross = jnp.maximum(n, jnp.maximum(w_, jnp.maximum(c, jnp.maximum(e, s_))))
    max_all = jnp.maximum(max_cross, jnp.maximum(nw, jnp.maximum(ne, jnp.maximum(sw, se))))
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)
    one = jnp.asarray(1.0, ln.dtype)
    lo = minlen / (one - minlen)
    hi = (one - maxlen) / maxlen
    sc = jnp.where(lo < hi, lo, hi)
    sc = jnp.where(jnp.isnan(sc), jnp.zeros((), ln.dtype), sc)
    sc = -jnp.asarray(sharpen, ln.dtype) * jnp.sqrt(jnp.maximum(sc, 0.0))
    out = (c + sc * (n + w_ + e + s_)) / (one + 4.0 * sc)
    # the 1:-1 row slicing above already consumed the halo rows: `c` is
    # exactly the local row block
    return out


def _sp_body(img_block: jnp.ndarray, plan: UpscalePlan, S: int, axis_name: str):
    """shard_map body: (h/S, w, C) uint8 block -> (H/S, W, C) uint8 block."""
    u = plan.integer_upscale
    h, w = plan.h, plan.w
    # pad half-spectrum cols (w/2+1) up to a multiple of S so A2A splits evenly
    kpad = ((w // 2 + 1 + S - 1) // S) * S
    cdtype = plan.precision.compute_dtype

    x = cas_ops.normalize_u8(img_block, cdtype)
    x = jnp.moveaxis(x, -1, 0)  # (C, h/S, w)

    # x-FFT local over complete rows (row-pair packed R2C)
    Fr, Fi = rfft2_packed_rows_only(x)
    # pad cols to a multiple of S, re-pencil: (C, h/S, kpad) -> (C, h, kpad/S)
    padc = kpad - Fr.shape[-1]
    Fr = jnp.pad(Fr, [(0, 0), (0, 0), (0, padc)])
    Fi = jnp.pad(Fi, [(0, 0), (0, 0), (0, padc)])
    Fr = jax.lax.all_to_all(Fr, axis_name, split_axis=2, concat_axis=1, tiled=True)
    Fi = jax.lax.all_to_all(Fi, axis_name, split_axis=2, concat_axis=1, tiled=True)

    # y-FFT local over full h
    Fr, Fi = fft((Fr, Fi), axis=-2)

    dt = Fr.dtype.name
    keep_nyquist = plan.kept_hi_x > 0
    kx = w // 2 + (1 if keep_nyquist else 0)

    # phase inverse: y-pass local (cols sharded), A2A, x-pass local
    out_rows = []
    for ry in range(u):
        Br, Bi = fft(
            _mul_row_twiddle((Fr, Fi), _phase_twiddle_y(h, u, ry, dt), axis=-2),
            axis=-2,
            inverse=True,
            normalize=True,
        )
        # back to rows sharded: (C, h, kpad/S) -> (C, h/S, kpad)
        Br = jax.lax.all_to_all(Br, axis_name, split_axis=1, concat_axis=2, tiled=True)
        Bi = jax.lax.all_to_all(Bi, axis_name, split_axis=1, concat_axis=2, tiled=True)
        Br, Bi = Br[..., :kx], Bi[..., :kx]
        cols = []
        for rx in range(u):
            Pp = _mul_row_twiddle((Br, Bi), _phase_twiddle_x_r2c(w, u, rx, kx, dt), axis=-1)
            cols.append(_c2r_rows_packed(Pp, w, keep_nyquist, 128))
        # interleave x phases with strided scatters (minor-dim-u stacks
        # can be padded to 128 elements by tiled layouts — avoid)
        xi = jnp.zeros(cols[0].shape[:-1] + (u * w,), cols[0].dtype)
        for rx in range(u):
            xi = xi.at[..., rx::u].set(cols[rx])
        out_rows.append(xi)
    # interleave y phases (sublane stride)
    v = jnp.zeros(
        out_rows[0].shape[:-2] + (u * x.shape[-2], u * w), out_rows[0].dtype
    )
    for ry in range(u):
        v = v.at[..., ry::u, :].set(out_rows[ry])

    out = _cas_sharded(v, plan.sharpen, axis_name)
    out = cas_ops.quantize_u8(out)
    return jnp.moveaxis(out, 0, -1)  # (H/S, W, C)


def rfft2_packed_rows_only(x: jnp.ndarray):
    """Row-pair packed R2C x-pass only (no y transform): (..., r, w) real
    -> (..., r, w/2+1) complex."""
    h, w = x.shape[-2], x.shape[-1]
    assert h % 2 == 0
    zr = x[..., 0::2, :]
    zi = x[..., 1::2, :]
    Zr, Zi = fft((zr, zi), axis=-1)
    Zr_rev = jnp.concatenate([Zr[..., :1], jnp.flip(Zr[..., 1:], -1)], -1)
    Zi_rev = jnp.concatenate([Zi[..., :1], jnp.flip(Zi[..., 1:], -1)], -1)
    kk = w // 2 + 1
    Zr_, Zi_ = Zr[..., :kk], Zi[..., :kk]
    Zr_rev, Zi_rev = Zr_rev[..., :kk], Zi_rev[..., :kk]
    er = 0.5 * (Zr_ + Zr_rev)
    ei = 0.5 * (Zi_ - Zi_rev)
    dr = 0.5 * (Zi_ + Zi_rev)
    di = 0.5 * (Zr_rev - Zr_)
    Fr = jnp.stack([er, dr], axis=-2).reshape(x.shape[:-2] + (h, kk))
    Fi = jnp.stack([ei, di], axis=-2).reshape(x.shape[:-2] + (h, kk))
    return Fr, Fi


@functools.lru_cache(maxsize=16)
def build_sp_upscale(plan: UpscalePlan, mesh: Mesh, axis_name: str = "sp") -> Callable:
    """One frame (h, w, C) uint8, rows sharded over `axis_name` ->
    (H, W, C) uint8, rows sharded.  Requires the matmul fast path
    (integer u, even 7-smooth dims) and h % (2*S) == 0."""
    S = mesh.shape[axis_name]
    if plan.integer_upscale is None:
        raise ValueError("distributed pipeline requires an integer upscale factor")
    if plan.h % (2 * S):
        raise ValueError(f"h={plan.h} must divide into 2*{S} row-paired shards")

    body = functools.partial(_sp_body, plan=plan, S=S, axis_name=axis_name)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(axis_name, None, None),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# dense-engine pencil pipeline (integer factors)
# ---------------------------------------------------------------------------
#
# Layout walk (S = shard count, per-chip shapes), dense row-split engine:
#   input   (h/S, w, C) u8      rows sharded
#   x pass  local split-bf16 matmul           -> U (C, h/S, W)
#   A2A     re-pencil to columns sharded      -> U (C, h, W/S)
#   y pass  local Ymat_ns matmul (full h)     -> O (C, h*(u-1), W/S)
#   weave   rows local                        -> v (C, H, W/S)
#   CAS     with 1-col halo exchange          -> (H, W/S, C) u8, cols sharded
# The y-Nyquist correction rows need a psum of a tiny (r, w) reduction —
# the only collective besides the single all-to-all.


def _halo_cols(x: jnp.ndarray, axis_name: str):
    """Exchange one edge column with ring neighbors along `axis_name`,
    clamping at the global x edges (CAS clamp-to-edge)."""
    s = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    left = x[..., :, :1]
    right = x[..., :, -1:]
    from_prev = jax.lax.ppermute(
        right, axis_name, [(i, (i + 1) % s) for i in range(s)]
    )
    from_next = jax.lax.ppermute(
        left, axis_name, [(i, (i - 1) % s) for i in range(s)]
    )
    before = jnp.where(idx == 0, left, from_prev)
    after = jnp.where(idx == s - 1, right, from_next)
    return before, after


def _cas_sharded_cols(v: jnp.ndarray, sharpen: float, axis_name: str):
    """CAS over column-sharded (..., H, cols) with column halos."""
    before, after = _halo_cols(v, axis_name)
    vpad = jnp.concatenate([before, v, after], axis=-1)
    ln = jnp.clip(jnp.abs(vpad), 0.0, 1.0)
    p = jnp.pad(ln, [(0, 0)] * (ln.ndim - 2) + [(1, 1), (0, 0)], mode="edge")
    c = p[..., 1:-1, 1:-1]
    n = p[..., :-2, 1:-1]
    s_ = p[..., 2:, 1:-1]
    w_ = p[..., 1:-1, :-2]
    e = p[..., 1:-1, 2:]
    nw = p[..., :-2, :-2]
    ne = p[..., :-2, 2:]
    sw = p[..., 2:, :-2]
    se = p[..., 2:, 2:]
    min_cross = jnp.minimum(n, jnp.minimum(w_, jnp.minimum(c, jnp.minimum(e, s_))))
    min_all = jnp.minimum(
        min_cross, jnp.minimum(nw, jnp.minimum(ne, jnp.minimum(sw, se)))
    )
    max_cross = jnp.maximum(n, jnp.maximum(w_, jnp.maximum(c, jnp.maximum(e, s_))))
    max_all = jnp.maximum(
        max_cross, jnp.maximum(nw, jnp.maximum(ne, jnp.maximum(sw, se)))
    )
    minlen = 0.5 * (min_cross + min_all)
    maxlen = 0.5 * (max_cross + max_all)
    one = jnp.asarray(1.0, ln.dtype)
    a, b = minlen, one - minlen
    cq, d = one - maxlen, maxlen
    pred = a * d < cq * b
    sc = jnp.where(pred, a, cq) / jnp.where(pred, b, d)
    sc = -jnp.asarray(sharpen, ln.dtype) * jnp.sqrt(jnp.maximum(sc, 0.0))
    return (c + sc * (n + w_ + e + s_)) / (one + 4.0 * sc)


def _sp_dense_body(
    img_block: jnp.ndarray, plan: UpscalePlan, banks: dict, S: int, axis_name: str
):
    """shard_map body: (h/S, w, C) uint8 rows-block -> (H, W/S, C) uint8
    columns-block."""
    from ..fft import dense

    u = plan.integer_upscale
    h, w, W = plan.h, plan.w, plan.W
    prec = plan.precision.matmul_precision

    x_raw = jnp.moveaxis(img_block, -1, -3)  # (C, h/S, w)
    xb = x_raw.astype(banks["alpha_hi"].dtype)
    x_cat = jnp.concatenate([xb, xb], axis=-1)
    a_cat = jnp.concatenate([banks["alpha_hi"], banks["alpha_lo"]], axis=0)
    U = jnp.einsum(
        "...hk,kn->...hn", x_cat, a_cat, preferred_element_type=jnp.float32
    )  # (C, h/S, W)

    # re-pencil: rows sharded -> columns sharded
    U = jax.lax.all_to_all(U, axis_name, split_axis=2, concat_axis=1, tiled=True)
    # (C, h, W/S)

    Uaug = U
    if "Y1n" in banks:
        # the correction contracts over ALL image rows: each shard applies
        # its own slice of Y1 to its local rows, then a (tiny) psum
        idx = jax.lax.axis_index(axis_name)
        rows_loc = h // S
        y1_loc = jax.lax.dynamic_slice_in_dim(
            banks["Y1n"], idx * rows_loc, rows_loc, axis=0
        )
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        t_part = jnp.einsum(
            "...hw,hr->...rw", x_raw.astype(jnp.float32), y1_loc,
            precision=jax.lax.Precision.HIGHEST,
        )
        tcorr = jax.lax.psum(t_part, axis_name)
        t2 = jnp.einsum("...rw,wn->...rn", tcorr, banks["beta"], precision=prec)
        cols = W // S
        t2_loc = jax.lax.dynamic_slice_in_dim(t2, idx * cols, cols, axis=-1)
        Uaug = jnp.concatenate([U, t2_loc], axis=-2)

    O = jnp.einsum("jm,...jn->...mn", banks["Ymat_ns"], Uaug, precision=prec)
    v = dense.weave_rows(U, O, u)  # (C, H, W/S)

    out = _cas_sharded_cols(v, plan.sharpen, axis_name)
    out = cas_ops.quantize_u8(out)
    return jnp.moveaxis(out, -3, -1)  # (H, W/S, C)


def _build_sp_banked(plan, mesh, axis_name, banks_np, body_fn):
    """Shared scaffolding of the banked pencil builders: device-put the
    banks, shard_map the body (frame rows-sharded in, columns-sharded
    out, banks replicated), jit, and close over the resident banks."""
    S = mesh.shape[axis_name]
    banks = jax.device_put(
        {k: jnp.asarray(v) for k, v in banks_np.items()}
    )

    def body(img, bb):
        return body_fn(img, plan=plan, banks=bb, S=S, axis_name=axis_name)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name, None, None), jax.tree.map(lambda _: P(), banks)),
        out_specs=P(None, axis_name, None),
    )
    jitfn = jax.jit(sharded)

    def run(img, _fn=jitfn, _banks=banks):
        return _fn(img, _banks)

    return run


@functools.lru_cache(maxsize=16)
def build_sp_upscale_dense(
    plan: UpscalePlan, mesh: Mesh, axis_name: str = "sp"
) -> Callable:
    """Dense-engine pencil pipeline: one frame (h, w, C) uint8 rows-sharded
    in, (H, W, C) uint8 columns-sharded out.  Requires the row-split fast
    path (integer u >= 2) plus h % S == 0 and W % S == 0."""
    from ..fft import dense as dense_mod
    from ..fft.mxu_pipeline import make_dense_banks

    S = mesh.shape[axis_name]
    if not dense_mod.r2c_rows_supported(plan):
        raise ValueError(
            "dense pencil pipeline requires an integer upscale factor >= 2 "
            "(row-split fast path)"
        )
    if plan.h % S or plan.W % S:
        raise ValueError(
            f"h={plan.h} and W={plan.W} must divide into {S} shards"
        )
    return _build_sp_banked(
        plan, mesh, axis_name, make_dense_banks(plan), _sp_dense_body
    )


def _sp_staged_body(
    img_block: jnp.ndarray, plan: UpscalePlan, banks: dict, S: int,
    axis_name: str,
):
    """shard_map body for the STAGED pencil pipeline: (h/S, w, C) uint8
    rows-block -> (H, W/S, C) uint8 columns-block.

    The staged circulant engine (fft/staged.py) maps onto the pencil
    decomposition with the same collective budget as the dense variant —
    ONE all-to-all (both x-phase planes stacked and re-penciled in a
    single collective) plus a tiny psum for the rank-1 y-Nyquist
    correction row — but with O(n*n1) banks instead of O(n^2), so
    cross-chip frames keep working at sizes where dense banks are GBs
    (the reference's multi-upload mechanism, vkFFT.h:4733-4771, never
    leaves one GPU).  x convolutions run on the rows pencil (lane axis
    complete), y convolutions on the columns pencil (row axis complete);
    the quad parity planes are woven locally and CAS runs with 1-column
    halos (_cas_sharded_cols)."""
    from ..fft.staged import (
        conv_apply_lanes,
        conv_apply_rows,
        staged_precision,
    )

    h, w = plan.h, plan.w
    prec = staged_precision()
    acc = banks["stx_b1"].dtype
    x_raw = jnp.moveaxis(img_block, -1, -3)  # (C, h/S, w)
    xf = x_raw.astype(acc)

    # x phase planes — local: the lanes axis is complete on this pencil
    P01 = conv_apply_lanes(xf, banks, "stx_", prec)
    signs = jnp.asarray((-1.0) ** np.arange(w), acc)
    isign = jnp.asarray(
        np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
    )
    q = jnp.sum(
        x_raw.astype(jnp.int32) * isign, axis=-1, keepdims=True
    ).astype(acc)
    P00 = xf * jnp.asarray(1.0 / 255.0, acc) - (signs * q) * jnp.asarray(
        1.0 / (255.0 * w), acc
    )

    # rank-1 y-Nyquist correction: contracts over ALL image rows — each
    # shard applies its slice of the (-1)^t column, then a psum of the
    # single (C, 1, w) row; the chi convs then run locally (full w)
    idx = jax.lax.axis_index(axis_name)
    t2e = t2o = None
    if "st_y1n" in banks:
        rows_loc = h // S
        y1_loc = jax.lax.dynamic_slice_in_dim(
            banks["st_y1n"], idx * rows_loc, rows_loc, axis=0
        )
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jax.lax.psum(
            jnp.einsum(
                "...hw,hr->...rw", xf, y1_loc,
                precision=jax.lax.Precision.HIGHEST,
            ),
            axis_name,
        )
        t2o = conv_apply_lanes(tcorr, banks, "stbo_", prec)
        t2e = conv_apply_lanes(tcorr, banks, "stbe_", prec)

    # ONE all-to-all: both x-phase planes re-penciled together
    Pst = jnp.stack([P00, P01])  # (2, C, h/S, w)
    Pst = jax.lax.all_to_all(
        Pst, axis_name, split_axis=3, concat_axis=2, tiled=True
    )  # (2, C, h, w/S)

    # y convs — local: the row axis is complete on this pencil; the
    # correction rows are sliced to this shard's columns and injected
    # into the DC bin of the small spectral intermediate (even n1) or
    # added post-hoc (odd n1), as in r2c_quad_staged
    cols = w // S
    n1 = banks["sty_m"].shape[2]
    dc_e = dc_o = post = None
    if t2e is not None:
        from ..fft.staged import ynyq_dc_or_post

        t2e = jax.lax.dynamic_slice_in_dim(t2e, idx * cols, cols, axis=-1)
        t2o = jax.lax.dynamic_slice_in_dim(t2o, idx * cols, cols, axis=-1)
        dcf, post = ynyq_dc_or_post(banks["st_yc"], n1, n1, 1, h, acc)
        if dcf is not None:
            dc_e, dc_o = dcf * t2e, dcf * t2o
    P00c, P01c = Pst[0], Pst[1]
    P10 = conv_apply_rows(P00c, banks, "sty_", prec, dc_add=dc_e)
    P11 = conv_apply_rows(P01c, banks, "sty_", prec, dc_add=dc_o)
    if post is not None:
        P10 = P10 + post * t2e
        P11 = P11 + post * t2o

    # local weave (this shard's output columns are contiguous: global
    # output col = 2*input col + parity), then CAS with 1-column halos
    E = jnp.stack([P00c, P01c], axis=-1).reshape(
        P00c.shape[:-1] + (2 * cols,)
    )
    D = jnp.stack([P10, P11], axis=-1).reshape(P10.shape[:-1] + (2 * cols,))
    v = jnp.stack([E, D], axis=-2).reshape(
        E.shape[:-2] + (2 * h, 2 * cols)
    )
    out = _cas_sharded_cols(v, plan.sharpen, axis_name)
    out = cas_ops.quantize_u8(out)
    return jnp.moveaxis(out, -3, -1)  # (H, W/S, C)


@functools.lru_cache(maxsize=16)
def build_sp_upscale_staged(
    plan: UpscalePlan, mesh: Mesh, axis_name: str = "sp"
) -> Callable:
    """Staged-engine pencil pipeline: one frame (h, w, C) uint8
    rows-sharded in, (H, W, C) uint8 columns-sharded out.  Same
    collective budget as the dense pencil variant (one all-to-all + a
    tiny psum + 1-column CAS halos) with O(n*n1) bank bytes — the
    any-size cross-chip tier.  Requires u=2 (quad staged form),
    h % S == 0 and w % S == 0."""
    from ..fft import staged as staged_mod

    S = mesh.shape[axis_name]
    if not staged_mod.staged_supported(plan):
        raise ValueError(
            "staged pencil pipeline requires a u=2 plan with usable "
            "Cooley-Tukey splits on both axes"
        )
    if plan.h % S or plan.w % S:
        raise ValueError(
            f"h={plan.h} and w={plan.w} must divide into {S} shards"
        )
    return _build_sp_banked(
        plan, mesh, axis_name, staged_mod.r2c_quad_staged_banks(plan), _sp_staged_body
    )


def _sp_grid_body(
    img_block: jnp.ndarray, plan: UpscalePlan, banks: dict, S: int,
    axis_name: str,
):
    """shard_map body for the GRID staged pencil pipeline (r2c, integer
    u >= 2 or fractional p/q): (h/S, w, C) uint8 rows-block ->
    (H, W/S, C) uint8 columns-block.

    Mirrors fft/staged.py r2c_grid_staged with the pencil re-layout
    inserted between the axis passes: the p x-phase planes compute
    locally on the rows pencil and re-pencil in ONE stacked all-to-all;
    the p^2 y convolutions run locally on the columns pencil; the rank-1
    y-Nyquist correction row is one tiny psum.  O(p * n * n1) banks."""
    from ..fft.staged import (
        conv_apply_lanes,
        conv_apply_rows,
        grid_u,
        staged_precision,
    )

    h, w = plan.h, plan.w
    prec = staged_precision()
    acc = banks["sgx1_b1"].dtype
    u = grid_u(banks)
    qd = banks["sgy1_m"].shape[2] // banks["sgy1_m"].shape[4]
    x_raw = jnp.moveaxis(img_block, -1, -3)  # (C, h/S, w)
    xf = x_raw.astype(acc)

    # x phase planes — local (lane axis complete on the rows pencil)
    signs_out = jnp.asarray((-1.0) ** (qd * np.arange(w // qd)), acc)
    isign = jnp.asarray(
        np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
    )
    q = jnp.sum(
        x_raw.astype(jnp.int32) * isign, axis=-1, keepdims=True
    ).astype(acc)
    xs = xf if qd == 1 else xf[..., ::qd]
    P0 = [
        xs * jnp.asarray(1.0 / 255.0, acc)
        - (signs_out * q) * jnp.asarray(1.0 / (255.0 * w), acc)
    ]
    for rx in range(1, u):
        P0.append(conv_apply_lanes(xf, banks, f"sgx{rx}_", prec))

    # rank-1 y-Nyquist correction: psum of the (C, 1, w) signed row, then
    # local chi convs (full w available on every shard pre-A2A)
    idx = jax.lax.axis_index(axis_name)
    tc = None
    if "sg_y1n" in banks:
        rows_loc = h // S
        y1_loc = jax.lax.dynamic_slice_in_dim(
            banks["sg_y1n"], idx * rows_loc, rows_loc, axis=0
        )
        # rank-r correction: matrix-vector work, full f32 (XLA's CPU
        # backend has no three-pass bf16 matrix-vector dot)
        tcorr = jax.lax.psum(
            jnp.einsum(
                "...hw,hr->...rw", xf, y1_loc,
                precision=jax.lax.Precision.HIGHEST,
            ),
            axis_name,
        )
        tc = [
            conv_apply_lanes(tcorr, banks, f"sgb{rx}_", prec)
            for rx in range(u)
        ]

    # ONE all-to-all: all p x-phase planes re-penciled together
    Pst = jnp.stack(P0)  # (p, C, h/S, w/qd)
    Pst = jax.lax.all_to_all(
        Pst, axis_name, split_axis=3, concat_axis=2, tiled=True
    )  # (p, C, h, w/(qd*S))

    cols = (w // qd) // S
    if tc is not None:
        tc = [
            jax.lax.dynamic_slice_in_dim(t, idx * cols, cols, axis=-1)
            for t in tc
        ]
    # ry = 0 planes: identity y roundtrip sampled at rows qd*m
    planes = [
        (Pst[rx] if qd == 1 else Pst[rx][..., ::qd, :]) for rx in range(u)
    ]
    for ry in range(1, u):
        n1 = banks[f"sgy{ry}_m"].shape[2]
        nd = banks[f"sgy{ry}_m"].shape[4]
        dcf = postf = None
        if tc is not None:
            from ..fft.staged import ynyq_dc_or_post

            dcf, postf = ynyq_dc_or_post(
                banks[f"sg_yc{ry}"], n1, nd, qd, h // qd, acc
            )
        for rx in range(u):
            dc = dcf * tc[rx] if dcf is not None else None
            Pyx = conv_apply_rows(Pst[rx], banks, f"sgy{ry}_", prec, dc_add=dc)
            if postf is not None:
                Pyx = Pyx + postf * tc[rx]
            planes.append(Pyx)

    # local weave (output columns are contiguous per shard: global output
    # col = p*input col + rx), then CAS with 1-column halos
    hq = h // qd
    g = jnp.stack(planes)  # (p*p, C, hq, cols)
    g = g.reshape((u, u) + g.shape[1:])
    g = jnp.moveaxis(jnp.moveaxis(g, 0, -2), 0, -1)  # (C, hq, p, cols, p)
    v = g.reshape(g.shape[:-4] + (u * hq, u * cols))
    out = _cas_sharded_cols(v, plan.sharpen, axis_name)
    out = cas_ops.quantize_u8(out)
    return jnp.moveaxis(out, -3, -1)  # (H, W/S, C)


@functools.lru_cache(maxsize=16)
def build_sp_upscale_grid(
    plan: UpscalePlan, mesh: Mesh, axis_name: str = "sp"
) -> Callable:
    """Grid staged pencil pipeline (r2c, any integer u >= 2 or
    fractional p/q — any exact rational the integer geometry realizes
    with q | dims): one frame rows-sharded in, columns-sharded out.
    One all-to-all + a tiny psum, O(p*n*n1) banks — the u-generic
    any-size cross-chip tier."""
    from ..fft import staged as staged_mod

    S = mesh.shape[axis_name]
    params = staged_mod.grid_params(plan)
    if params is None:
        raise ValueError(
            "grid pencil pipeline requires a grid-staged-executable r2c "
            "plan (integer u >= 2 or exact rational p/q with q | dims "
            "and matching band keep-set, usable splits)"
        )
    p, qd = params
    if plan.h % S or (plan.w // qd) % S:
        raise ValueError(
            f"h={plan.h} and w/q={plan.w // qd} must divide into {S} shards"
        )
    return _build_sp_banked(
        plan, mesh, axis_name, staged_mod.r2c_grid_staged_banks(plan), _sp_grid_body
    )


def _sp_c2c_grid_body(
    img_block: jnp.ndarray, plan: UpscalePlan, banks: dict, S: int,
    axis_name: str,
):
    """shard_map body for the c2c GRID staged pencil pipeline:
    (h/S, w, C) uint8 rows-block -> (H, W/S, C) uint8 columns-block.

    Mirrors fft/staged.py c2c_grid_staged on the pencil layout: the p
    x-phase planes compute locally and re-pencil in ONE stacked
    all-to-all; the rank-1 Nyquist machinery needs only a psum of the
    signed column-sum row (contracts over the sharded row axis) and an
    all_gather of the (h, 1) signed row-sum column — both tiny.  CAS
    consumes the locally-woven magnitudes with 1-column halos."""
    from ..fft.staged import (
        c2c_grid_u,
        c2c_planes_from_pencils,
        conv_apply_lanes,
        conv_apply_rows,
        staged_precision,
    )

    h, w = plan.h, plan.w
    prec = staged_precision()
    acc = banks["cgx1_b1"].dtype
    u = c2c_grid_u(banks)
    qd = banks["cgy1_m"].shape[2] // banks["cgy1_m"].shape[4]
    x_raw = jnp.moveaxis(img_block, -1, -3)  # (C, h/S, w)
    xf = x_raw.astype(acc)
    inv255 = jnp.asarray(1.0 / 255.0, acc)
    idx = jax.lax.axis_index(axis_name)
    rows_loc = h // S

    # signed sums: qcol contracts over the SHARDED row axis -> local
    # partial with this shard's sign slice, then a psum of one row;
    # prow is local (lane axis complete) and all_gathers to full height
    isy_full = np.where(np.arange(h) % 2 == 0, 1, -1).astype(np.int32)
    isy_loc = jax.lax.dynamic_slice_in_dim(
        jnp.asarray(isy_full), idx * rows_loc, rows_loc, axis=0
    )
    isx = jnp.asarray(
        np.where(np.arange(w) % 2 == 0, 1, -1).astype(np.int32)
    )
    xi = x_raw.astype(jnp.int32)
    qcol_i = jax.lax.psum(
        jnp.sum(xi * isy_loc[:, None], axis=-2, keepdims=True), axis_name
    )
    qcol = qcol_i.astype(acc)  # (C, 1, w), full on every shard
    prow_loc = jnp.sum(xi * isx, axis=-1, keepdims=True).astype(acc)
    prow = jax.lax.all_gather(
        prow_loc, axis_name, axis=-2, tiled=True
    )  # (C, h, 1), full on every shard
    # second reduction leaves int32 BEFORE summing: the double sum can
    # exceed 2^31 on large frames (see staged.c2c_grid_staged); qcol_i
    # entries (<= 255*h) are f32-exact
    Sn = (
        jnp.sum(
            qcol * jnp.asarray((-1.0) ** np.arange(w), acc),
            axis=-1,
            keepdims=True,
        )
        * inv255
    )  # (C, 1, 1)

    # x phase planes — local; rank-1 vectors reuse the plane banks
    xs = xf if qd == 1 else xf[..., ::qd]
    A = [xs * inv255]
    V = [(qcol if qd == 1 else qcol[..., ::qd]) * inv255]
    for rx in range(1, u):
        A.append(conv_apply_lanes(xf, banks, f"cgx{rx}_", prec))
        V.append(conv_apply_lanes(qcol, banks, f"cgx{rx}_", prec))
    Wv = [(prow if qd == 1 else prow[..., ::qd, :]) * inv255]
    for ry in range(1, u):
        Wv.append(
            conv_apply_rows(prow, banks, f"cgy{ry}_", prec) * inv255
        )

    # ONE all-to-all: all p x-phase planes re-penciled together
    Pst = jnp.stack(A)  # (p, C, h/S, w/qd)
    Pst = jax.lax.all_to_all(
        Pst, axis_name, split_axis=3, concat_axis=2, tiled=True
    )  # (p, C, h, w/(qd*S))

    cols = (w // qd) // S
    V = [
        jax.lax.dynamic_slice_in_dim(v, idx * cols, cols, axis=-1)
        for v in V
    ]
    sYo = jnp.asarray((-1.0) ** (qd * np.arange(h // qd)), acc)[:, None]
    sXo_full = jnp.asarray((-1.0) ** (qd * np.arange(w // qd)), acc)
    sXo = jax.lax.dynamic_slice_in_dim(sXo_full, idx * cols, cols, axis=0)

    # shared re/im plane algebra (fft/staged.py) with the pencil's
    # pre-sliced V/sXo — the rank-1 math lives in ONE place
    planes = c2c_planes_from_pencils(
        [Pst[rx] for rx in range(u)], V, Wv, Sn, banks, prec, sYo, sXo, qd
    )

    hq = h // qd
    g = jnp.stack(planes).reshape((u, u) + planes[0].shape)
    g = jnp.moveaxis(jnp.moveaxis(g, 0, -2), 0, -1)  # (C, hq, ry, cols, rx)
    v = g.reshape(g.shape[:-4] + (u * hq, u * cols))
    out = _cas_sharded_cols(v, plan.sharpen, axis_name)
    out = cas_ops.quantize_u8(out)
    return jnp.moveaxis(out, -3, -1)  # (H, W/S, C)


@functools.lru_cache(maxsize=16)
def build_sp_upscale_c2c_grid(
    plan: UpscalePlan, mesh: Mesh, axis_name: str = "sp"
) -> Callable:
    """c2c grid staged pencil pipeline: one frame rows-sharded in,
    columns-sharded out.  One all-to-all + two tiny collectives for the
    rank-1 Nyquist sums, O(p*n*n1) banks."""
    from ..fft import staged as staged_mod

    S = mesh.shape[axis_name]
    params = staged_mod.c2c_grid_params(plan)
    if params is None:
        raise ValueError(
            "c2c grid pencil pipeline requires a c2c-grid-staged-"
            "executable plan (integer u >= 2 or exact rational p/q "
            "with q | dims and matching band keep-set)"
        )
    p, qd = params
    if plan.h % S or (plan.w // qd) % S:
        raise ValueError(
            f"h={plan.h} and w/q={plan.w // qd} must divide into {S} shards"
        )
    return _build_sp_banked(
        plan, mesh, axis_name, staged_mod.c2c_grid_staged_banks(plan), _sp_c2c_grid_body
    )
