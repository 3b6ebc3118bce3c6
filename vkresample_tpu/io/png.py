"""PNG I/O: ctypes binding to the native libpng codec, with PIL fallback.

The native module (native/pngio.cpp) fills the role of the reference's
vendored stb_image/stb_image_write (VkResample.cpp:1362, 1754) plus its
decode worker threads.  It is built lazily with `make` on first use; if the
toolchain or libpng is unavailable we fall back to PIL (pure-Python path,
same pixel semantics: force 3-channel RGB).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libvkrpng.so"))

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _encode_err(rc, path) -> str:
    """Encode-failure message with the usual cause spelled out (the
    reference's stbi_write_png silently writes nothing on failure,
    VkResample.cpp:1754 — we raise instead)."""
    import os

    d = os.path.dirname(str(path)) or "."
    hint = "" if os.path.isdir(d) else f" (output directory {d!r} does not exist)"
    return f"PNG encode failed ({rc}): {path}{hint}"


def _require(cond: bool, msg: str) -> None:
    """Explicit raise (not assert) for shape/count checks at the ctypes
    boundary: asserts are stripped under python -O, and a wrong plane
    count would hand NULL pointers to the C++ row loop."""
    if not cond:
        raise ValueError(msg)




def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        src = os.path.abspath(os.path.join(_NATIVE_DIR, "pngio.cpp"))
        stale = os.path.exists(src) and (
            not os.path.exists(_LIB_PATH)
            or os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
        )
        if stale:
            # Always (re)build from source — a stale binary silently
            # shadowing pngio.cpp edits cost a round-1 advisory finding.
            try:
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                if not os.path.exists(_LIB_PATH):
                    _lib_failed = True
                    return None
        elif not os.path.exists(_LIB_PATH):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib_failed = True
            return None
        lib.vkr_png_decode.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.vkr_png_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vkr_png_encode.restype = ctypes.c_int
        lib.vkr_png_encode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vkr_free.argtypes = [ctypes.c_void_p]
        lib.vkr_pool_create.restype = ctypes.c_void_p
        lib.vkr_pool_create.argtypes = [ctypes.c_int]
        lib.vkr_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.vkr_pool_decode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vkr_pool_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vkr_pool_encode_batch_planar.argtypes = (
            lib.vkr_pool_encode_batch.argtypes
        )
        lib.vkr_png_encode_planar.restype = ctypes.c_int
        lib.vkr_png_encode_planar.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vkr_png_encode_planar_parity.restype = ctypes.c_int
        lib.vkr_png_encode_planar_parity.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vkr_pool_encode_batch_planar_parity.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vkr_png_encode_planar_parity4.restype = ctypes.c_int
        lib.vkr_png_encode_planar_parity4.argtypes = [
            ctypes.c_char_p,
        ] + [ctypes.POINTER(ctypes.c_ubyte)] * 4 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vkr_pool_encode_batch_planar_parity4.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
        ] + [ctypes.POINTER(ctypes.c_ubyte)] * 4 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vkr_png_encode_planar_grid.restype = ctypes.c_int
        lib.vkr_png_encode_planar_grid.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vkr_pool_encode_batch_planar_grid.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


_NO_CODEC = (
    "no PNG codec: the native libpng codec did not build (`make -C "
    "vkresample_tpu/native` needs the libpng and zlib headers) and PIL "
    "is not installed"
)


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(_NO_CODEC) from e
    return Image


def codec_name() -> str:
    """The PNG codec this process uses: "native libpng" or "PIL".
    Raises RuntimeError up front when neither is usable, instead of
    failing deep inside a decode."""
    if native_available():
        return "native libpng"
    _pil()
    return "PIL"


# ---------------------------------------------------------------------------
# single-image API
# ---------------------------------------------------------------------------


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (h, w, 3) uint8 RGB (req_comp=3 semantics of the
    reference's stbi_load call)."""
    lib = _load_native()
    if lib is not None:
        w = ctypes.c_int()
        h = ctypes.c_int()
        buf = lib.vkr_png_decode(path.encode(), ctypes.byref(w), ctypes.byref(h))
        if buf:
            n = w.value * h.value * 3
            arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
            lib.vkr_free(buf)
            return arr.reshape(h.value, w.value, 3)
        raise FileNotFoundError(f"Image not found: {path}")
    Image = _pil()
    try:
        img = Image.open(path).convert("RGB")
    except (FileNotFoundError, OSError) as e:
        raise FileNotFoundError(f"Image not found: {path}") from e
    return np.asarray(img, np.uint8)


def write_png_planar(path: str, img: np.ndarray, compression_level: int = 6) -> None:
    """Encode PLANAR (3, h, w) uint8 RGB — the device pipeline's native
    output layout; the native encoder interleaves during row filtering."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[0] != 3:
        raise ValueError(f"expected (3, h, w) uint8, got {img.shape}")
    lib = _load_native()
    if lib is not None:
        _, h, w = img.shape
        plane = h * w
        base = img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        rc = lib.vkr_png_encode_planar(
            path.encode(),
            base,
            ctypes.cast(ctypes.addressof(base.contents) + plane, ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.cast(ctypes.addressof(base.contents) + 2 * plane, ctypes.POINTER(ctypes.c_ubyte)),
            w,
            h,
            compression_level,
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    write_png(path, np.moveaxis(img, 0, -1), compression_level)


def write_png_planar_parity(
    path: str, e: np.ndarray, d: np.ndarray, compression_level: int = 6
) -> None:
    """Encode from PARITY PLANES: e (3, H/2, W) even output rows, d the
    odd rows — the fused per-parity CAS kernel's native output layout.
    The row interleave happens inside the encoder's row loop (free); the
    device never weaves."""
    e = np.ascontiguousarray(e, np.uint8)
    d = np.ascontiguousarray(d, np.uint8)
    if e.shape != d.shape or e.ndim != 3 or e.shape[0] != 3:
        raise ValueError(f"expected matching (3, h, w) planes, got {e.shape} {d.shape}")
    lib = _load_native()
    _, h2, w = e.shape
    if lib is not None:
        rc = lib.vkr_png_encode_planar_parity(
            path.encode(),
            e.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w,
            2 * h2,
            compression_level,
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    img = np.stack([e, d], axis=2).reshape(3, 2 * h2, w)  # host weave
    write_png(path, np.moveaxis(img, 0, -1), compression_level)


def write_png_planar_parity4(
    path: str, planes, compression_level: int = 6
) -> None:
    """Encode from QUAD-PARITY planes: (p00, p01, p10, p11), each
    (3, H/2, W/2) uint8 (p[output row parity][output col parity]) — the
    quad pipeline's native layout; both interleaves happen inside the
    encoder's row loop (free)."""
    ps = [np.ascontiguousarray(p, np.uint8) for p in planes]
    if len(ps) != 4 or any(
        p.shape != ps[0].shape or p.ndim != 3 or p.shape[0] != 3 for p in ps
    ):
        raise ValueError(f"expected 4 matching (3, h, w) planes")
    lib = _load_native()
    _, h2, wh = ps[0].shape
    if lib is not None:
        rc = lib.vkr_png_encode_planar_parity4(
            path.encode(),
            *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) for p in ps],
            2 * wh,
            2 * h2,
            compression_level,
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    img = weave4_host(*ps)
    write_png(path, np.moveaxis(img, 0, -1), compression_level)


def write_png_planar_grid(
    path: str, planes, u: int, compression_level: int = 6
) -> None:
    """Encode from u-generic GRID-PARITY planes: u*u row-major (ry, rx)
    stacks, each (3, H/u, W/u) uint8 (output pixel (u*t+ry, u*s+rx) at
    plane (ry, rx) index (t, s)) — the u>=3 staged pipeline's native
    layout; both interleaves happen inside the encoder's row loop."""
    ps = [np.ascontiguousarray(p, np.uint8) for p in planes]
    if len(ps) != u * u or any(
        p.shape != ps[0].shape or p.ndim != 3 or p.shape[0] != 3 for p in ps
    ):
        raise ValueError(f"expected {u * u} matching (3, h, w) planes")
    lib = _load_native()
    _, hs, wss = ps[0].shape
    if lib is not None:
        ptrs = (ctypes.POINTER(ctypes.c_ubyte) * (u * u))(
            *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) for p in ps]
        )
        rc = lib.vkr_png_encode_planar_grid(
            path.encode(), ptrs, u, u * wss, u * hs, compression_level
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    img = weave_grid_host(ps, u)
    write_png(path, np.moveaxis(img, 0, -1), compression_level)


def weave_grid_host(planes, u: int) -> np.ndarray:
    """Host assembly of u*u grid-parity planes into (..., 3, H, W) uint8."""
    ps = [np.asarray(p, np.uint8) for p in planes]
    c, hs, wss = ps[0].shape[-3:]
    out = np.empty(ps[0].shape[:-3] + (c, u * hs, u * wss), np.uint8)
    for i, p in enumerate(ps):
        out[..., i // u :: u, i % u :: u] = p
    return out


def weave4_host(p00, p01, p10, p11) -> np.ndarray:
    """Host assembly of quad-parity planes into (..., 3, H, W) uint8."""
    c, h2, wh = p00.shape[-3:]
    out = np.empty(p00.shape[:-3] + (c, 2 * h2, 2 * wh), np.uint8)
    out[..., 0::2, 0::2] = p00
    out[..., 0::2, 1::2] = p01
    out[..., 1::2, 0::2] = p10
    out[..., 1::2, 1::2] = p11
    return out


def write_png(path: str, img: np.ndarray, compression_level: int = 6) -> None:
    """Encode (h, w, 3) uint8 RGB to a PNG file."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {img.shape}")
    lib = _load_native()
    if lib is not None:
        h, w = img.shape[:2]
        rc = lib.vkr_png_encode(
            path.encode(),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w,
            h,
            compression_level,
        )
        if rc != 0:
            raise OSError(_encode_err(rc, path))
        return
    _pil().fromarray(img, "RGB").save(path, compress_level=compression_level)


# ---------------------------------------------------------------------------
# batched (thread-pool) API — the -numthreads capability
# ---------------------------------------------------------------------------


class PngPool:
    """Worker pool for parallel PNG decode/encode of same-sized frames.

    Native path: one C++ pool (native/pngio.cpp).  Fallback: Python
    ThreadPoolExecutor over PIL (PIL releases the GIL during codec work).
    """

    def __init__(self, num_threads: int = 1):
        self.num_threads = max(1, int(num_threads))
        self._lib = _load_native()
        if self._lib is not None:
            self._pool = self._lib.vkr_pool_create(self.num_threads)
        else:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = None
            self._exec = ThreadPoolExecutor(max_workers=self.num_threads)

    def close(self):
        if self._lib is not None and self._pool:
            self._lib.vkr_pool_destroy(self._pool)
            self._pool = None
        elif getattr(self, "_exec", None) is not None:
            self._exec.shutdown()
            self._exec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def decode_batch(self, paths: Sequence[str], w: int, h: int) -> np.ndarray:
        """Decode N same-sized PNGs into one (N, h, w, 3) uint8 array."""
        n = len(paths)
        out = np.empty((n, h, w, 3), np.uint8)
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            self._lib.vkr_pool_decode_batch(
                self._pool,
                c_paths,
                n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                w,
                h,
                status,
            )
            for i, st in enumerate(status):
                if st == -1:
                    raise FileNotFoundError(f"Image not found: {paths[i]}")
                if st == -2:
                    raise ValueError(
                        f"size mismatch in batch: {paths[i]} is not {w}x{h}"
                    )
            return out
        futs = [self._exec.submit(read_png, p) for p in paths]
        for i, f in enumerate(futs):
            img = f.result()
            if img.shape[:2] != (h, w):
                raise ValueError(f"size mismatch in batch: {paths[i]}")
            out[i] = img
        return out

    def encode_batch(
        self, paths: Sequence[str], data: np.ndarray, compression_level: int = 6
    ) -> None:
        """Encode (N, h, w, 3) uint8 frames to N PNG files."""
        data = np.ascontiguousarray(data, np.uint8)
        n, h, w, _ = data.shape
        _require(n == len(paths), f"{len(paths)} paths for {n} frames")
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            self._lib.vkr_pool_encode_batch(
                self._pool,
                c_paths,
                n,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                w,
                h,
                compression_level,
                status,
            )
            for i, st in enumerate(status):
                if st != 0:
                    raise OSError(_encode_err(st, paths[i]))
            return
        futs = [
            self._exec.submit(write_png, p, data[i], compression_level)
            for i, p in enumerate(paths)
        ]
        for f in futs:
            f.result()

    def encode_batch_planar(
        self, paths: Sequence[str], data: np.ndarray, compression_level: int = 6
    ) -> None:
        """Encode PLANAR (N, 3, H, W) uint8 frames — the device pipeline's
        native output layout; the C++ encoder interleaves during row
        filtering (no host transpose)."""
        data = np.ascontiguousarray(data, np.uint8)
        n, c, h, w = data.shape
        _require(
            c == 3 and n == len(paths),
            f"(N,3,H,W) planar expected, got {data.shape} / {len(paths)} paths",
        )
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            self._lib.vkr_pool_encode_batch_planar(
                self._pool,
                c_paths,
                n,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                w,
                h,
                compression_level,
                status,
            )
            for i, st in enumerate(status):
                if st != 0:
                    raise OSError(_encode_err(st, paths[i]))
            return
        self.encode_batch(paths, np.moveaxis(data, 1, -1), compression_level)

    def encode_batch_planar_parity(
        self,
        paths: Sequence[str],
        e: np.ndarray,
        d: np.ndarray,
        compression_level: int = 6,
    ) -> None:
        """Encode PARITY-PLANE frames: e/d each (N, 3, H/2, W) uint8 (even
        and odd output rows).  The encoder interleaves rows per frame."""
        e = np.ascontiguousarray(e, np.uint8)
        d = np.ascontiguousarray(d, np.uint8)
        n, c, h2, w = e.shape
        _require(
            c == 3 and e.shape == d.shape and n == len(paths),
            f"parity planes mismatch: {e.shape} vs {d.shape}, {len(paths)} paths",
        )
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            self._lib.vkr_pool_encode_batch_planar_parity(
                self._pool,
                c_paths,
                n,
                e.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                d.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                w,
                2 * h2,
                compression_level,
                status,
            )
            for i, st in enumerate(status):
                if st != 0:
                    raise OSError(_encode_err(st, paths[i]))
            return
        img = np.stack([e, d], axis=3).reshape(n, 3, 2 * h2, w)
        self.encode_batch(paths, np.moveaxis(img, 1, -1), compression_level)

    def encode_batch_planar_parity4(
        self, paths: Sequence[str], planes, compression_level: int = 6
    ) -> None:
        """Encode QUAD-PARITY frames: 4 arrays (N, 3, H/2, W/2) uint8
        (p[row parity][col parity]); both interleaves happen per row in
        the encoder."""
        ps = [np.ascontiguousarray(p, np.uint8) for p in planes]
        n, c, h2, wh = ps[0].shape
        _require(
            c == 3 and len(paths) == n and len(ps) == 4,
            f"4 equal (N,3,H/2,W/2) planes expected, got {len(ps)} of "
            f"{ps[0].shape}, {len(paths)} paths",
        )
        _require(
            all(p.shape == ps[0].shape for p in ps), "plane shape mismatch"
        )
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            self._lib.vkr_pool_encode_batch_planar_parity4(
                self._pool,
                c_paths,
                n,
                *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) for p in ps],
                2 * wh,
                2 * h2,
                compression_level,
                status,
            )
            for i, st in enumerate(status):
                if st != 0:
                    raise OSError(_encode_err(st, paths[i]))
            return
        img = weave4_host(*ps)  # (N, 3, H, W)
        self.encode_batch(paths, np.moveaxis(img, 1, -1), compression_level)

    def encode_batch_planar_grid(
        self, paths: Sequence[str], planes, u: int,
        compression_level: int = 6,
    ) -> None:
        """Encode u-generic GRID-PARITY frames: u*u arrays (N, 3, H/u, W/u)
        uint8, row-major (ry, rx); both interleaves happen per row in the
        encoder."""
        ps = [np.ascontiguousarray(p, np.uint8) for p in planes]
        n, c, hs, wss = ps[0].shape
        _require(
            c == 3 and len(paths) == n and len(ps) == u * u,
            f"u*u={u * u} equal (N,3,H/u,W/u) planes expected, got "
            f"{len(ps)} of {ps[0].shape}, {len(paths)} paths",
        )
        _require(
            all(p.shape == ps[0].shape for p in ps), "plane shape mismatch"
        )
        if self._lib is not None:
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            status = (ctypes.c_int * n)()
            ptrs = (ctypes.POINTER(ctypes.c_ubyte) * (u * u))(
                *[
                    p.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
                    for p in ps
                ]
            )
            self._lib.vkr_pool_encode_batch_planar_grid(
                self._pool,
                c_paths,
                n,
                ptrs,
                u,
                u * wss,
                u * hs,
                compression_level,
                status,
            )
            for i, st in enumerate(status):
                if st != 0:
                    raise OSError(_encode_err(st, paths[i]))
            return
        img = weave_grid_host(ps, u)  # (N, 3, H, W)
        self.encode_batch(paths, np.moveaxis(img, 1, -1), compression_level)
