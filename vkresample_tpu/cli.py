"""Flag-compatible CLI.

Mirrors the reference's flag surface and defaults exactly
(/root/reference/VkResample.cpp:1795-1977, help text 1805-1825):

    -h -devices -d X -u X -p X -s X -n X
    -i NAME -o NAME
    -ifolder X -ofolder X -numfiles X -numthreads X

plus extras: -engine {auto,xla,mxu}, -c2c, -batch N, -validate, -profile,
-resume.

Parsing is a hand-rolled argv scan (findFlag/getFlagValue semantics,
VkResample.cpp:1782-1794) because the reference's single-dash long flags
don't fit argparse conventions.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

HELP = """\
vkresample-tpu v{version} — FFT-based upscaling on JAX/XLA (capabilities of VkResample v1.0.2)
Works with png images only, for now!
	-h: print help
	-devices: print the list of available accelerator devices
	-d X: select device (default 0)
	-u X: specify upscale factor (float, make sure that upscaled image can be represented as a multiplication of 2s, 3s, 5s and 7s)
	-p X: specify precision (0 - single, 1 - double, 2 - half, default - single)
	-s X: specify sharpening factor, range 0.0-0.2 (default 0.2)
	-n X: specify how many times to perform upscale. This removes dispatch overhead and will show the real application performance (default 1)
Single image mode:
	-i NAME: specify input png file path
	-o NAME: specify output png file path (default X_X_upscaled.png)
Batched mode:
	-ifolder X: specify input folder plus file prefix, like inp/img
	-ofolder X: specify output folder plus file prefix, like outp/img
	-numfiles X: specify how many images to upscale. They should have names like prefix + 000001.png with numbers padded with zeros to six digits. Temporary limitation.
	-numthreads X: specify how many threads to launch. Used to speed up png reads
Extras:
	-engine X: fft engine: auto (default), mxu (matmul FFT), xla (jnp.fft)
	-c2c: use the full-complex spectrum path instead of R2C
	-batch X: frames per device dispatch in batched mode (default: auto)
	-validate: cross-check device output against the fp64 NumPy oracle
	-profile DIR: capture a device profiler trace of the timed region
	-resume: batched mode: skip frames whose output file already exists
"""


def find_flag(argv: List[str], flag: str) -> bool:
    return flag in argv


def get_flag_value(argv: List[str], flag: str) -> Optional[str]:
    try:
        i = argv.index(flag)
    except ValueError:
        return None
    if i + 1 < len(argv):
        return argv[i + 1]
    return None


def _parse(argv: List[str]):
    """Parse argv into a ResampleConfig + extras; returns None on error."""
    from .core.config import Engine, Precision, ResampleConfig

    def req(flag, msg):
        v = get_flag_value(argv, flag)
        if v is None:
            print(msg)
            return None
        return v

    kw = {}
    if find_flag(argv, "-d"):
        v = req("-d", "No device is selected with -d flag")
        if v is None:
            return None
        kw["device_id"] = int(v)
    if find_flag(argv, "-n"):
        v = req("-n", "No number is selected with -n flag")
        if v is None:
            return None
        kw["num_iter"] = int(v)
    if find_flag(argv, "-p"):
        v = req("-p", "No precision is selected with -p flag")
        if v is None:
            return None
        kw["precision"] = Precision(int(v))
    if find_flag(argv, "-s"):
        v = req("-s", "No sharpening parameter is selected with -s flag")
        if v is None:
            return None
        kw["sharpen"] = float(v)
    if find_flag(argv, "-u"):
        v = get_flag_value(argv, "-u")
        if v is None:
            print("No proper upscale factor is selected with -u flag, default 1")
        else:
            kw["upscale"] = float(v)
    else:
        print("No upscale factor is selected with -u flag, default 1")
    if find_flag(argv, "-engine"):
        v = req("-engine", "No engine is selected with -engine flag")
        if v is None:
            return None
        kw["engine"] = Engine(v)

    if not find_flag(argv, "-ifolder"):
        v = get_flag_value(argv, "-i")
        if v is None:
            print("No input file is selected with -i flag")
            return None
        kw["input_path"] = v
        if find_flag(argv, "-o"):
            v = req("-o", "No output file is selected with -o flag")
            if v is None:
                return None
            kw["output_path"] = v
    else:
        v = get_flag_value(argv, "-ifolder")
        if v is None:
            print("No input folder+prefix is selected with -ifolder flag")
            return None
        kw["ifolder_prefix"] = v
        if find_flag(argv, "-ofolder"):
            v = req("-ofolder", "No output folder+prefix is selected with -ofolder flag")
            if v is None:
                return None
            kw["ofolder_prefix"] = v
        if find_flag(argv, "-numthreads"):
            v = req("-numthreads", "No numThreads is selected with -numthreads flag")
            if v is None:
                return None
            kw["num_threads"] = int(v)
        if find_flag(argv, "-numfiles"):
            v = req("-numfiles", "No numFiles is selected with -numfiles flag")
            if v is None:
                return None
            kw["num_files"] = int(v)

    cfg = ResampleConfig(**kw)
    extras = {
        "c2c": find_flag(argv, "-c2c"),
        "batch": int(get_flag_value(argv, "-batch") or 0),
        "validate": find_flag(argv, "-validate"),
        "profile": get_flag_value(argv, "-profile"),
        "resume": find_flag(argv, "-resume"),
    }
    return cfg, extras


# per-precision uint8 validation tolerance against the fp64 oracle.
# Every mode allows 1 LSB: the output is a truncating quantization, so a
# pixel whose exact value sits on an integer boundary flips by one under
# any change of summation order.  DOUBLE runs native f64 on the GPU, but
# its staged and dense matmuls still sum in another order than numpy's
# FFT; HALF adds its int16 Q2.14 pre-CAS storage (~0.008 LSB) and its
# matmul precision (core/config.py Precision.matmul_precision).
_VALIDATE_TOL = {0: 1, 1: 1, 2: 1}


def _validate(img, out_np, plan) -> int:
    """Cross-check one frame against the fp64 oracle (the reference's only
    correctness tooling was visual comparison — SURVEY §4; this is the
    --validate mode SURVEY §5.2 calls for)."""
    import numpy as np

    from .oracle.numpy_ref import upscale_oracle

    want = upscale_oracle(np.asarray(img), plan)
    diff = int(np.max(np.abs(out_np.astype(np.int64) - want.astype(np.int64))))
    tol = _VALIDATE_TOL[int(plan.precision)]
    status = "OK" if diff <= tol else "FAIL"
    print(f"Validation vs fp64 oracle: maxdiff={diff} LSB (tol {tol}) {status}")
    return 0 if diff <= tol else 1


def _make_plan(cfg, extras, h, w):
    from .core.plan import UpscalePlan

    plan = UpscalePlan(
        h=h,
        w=w,
        upscale=cfg.upscale,
        precision=cfg.precision,
        sharpen=cfg.sharpen,
        r2c=not extras["c2c"],
        engine=cfg.engine,
    )
    from .core.config import Engine

    if plan.resolve_engine() is Engine.MXU:
        plan.validate_7smooth()
    return plan


def _hbm_estimate_mb(plan) -> int:
    """Printed device-memory footprint, mirroring the reference's VRAM line
    (VkResample.cpp:1450: inputBufferSize + 2*bufferSize)."""
    cs = 16 if plan.precision.name == "DOUBLE" else 8  # complex element bytes
    small = 3 * (plan.w // 2 + 1) * plan.h * cs
    big = 3 * (plan.W // 2 + 1) * plan.H * cs
    return (small + 2 * big) // 1024 // 1024


def run_single(cfg, extras) -> int:
    import numpy as np

    from .core.config import default_output_name
    from .io.png import read_png, write_png_planar
    from .pipeline.timing import time_amortized
    from .pipeline.upscale import build_upscale
    import jax

    try:
        img = read_png(cfg.input_path)
    except FileNotFoundError:
        print("Image not found")
        return 1
    h, w = img.shape[:2]
    plan = _make_plan(cfg, extras, h, w)
    print(f"Device memory per device: {_hbm_estimate_mb(plan)} MB")

    dev = jax.devices()[cfg.device_id]
    # planar device output (like the reference's planar GPU buffers); the
    # native PNG encoder interleaves channels during encode.  Banks and
    # compilation are committed to the same -d device as the input.
    # parity-capable plans emit PARITY PLANES — the per-parity CAS's
    # native layouts ('quad': both axes split, 'rows': even/odd rows,
    # 'grid': u x u);
    # the encoder's row loop interleaves them for free
    # (pipeline/upscale.py planes_format).
    from .pipeline.upscale import planes_format

    fmt = planes_format(plan)
    fn = build_upscale(
        plan, planar_out=True, device_id=cfg.device_id,
        planes_out=fmt is not None,
    )
    x = jax.device_put(img, dev)
    from .utils.profiling import maybe_trace

    with maybe_trace(extras.get("profile")):
        out, ms = time_amortized(fn, (x,), cfg.num_iter)
    print(
        "vkresample-tpu %0.1fx upscale: %dx%d to %dx%d Time: %0.3f ms"
        % (cfg.upscale, w, h, plan.W, plan.H, ms)
    )
    rc = 0
    out_path = cfg.output_path or default_output_name(w, cfg.upscale)
    if fmt == "quad":
        ps = [np.asarray(p) for p in out]  # 4x (3, H/2, W/2)
        if extras.get("validate"):
            from .io.png import weave4_host

            rc = _validate(img, np.moveaxis(weave4_host(*ps), 0, -1), plan)
        from .io.png import write_png_planar_parity4

        write_png_planar_parity4(out_path, ps)
    elif fmt == "grid":
        # phase count p: == integer u, or the numerator of a fractional
        # factor p/q (planes are (H/p, W/p) either way)
        u = int(round(len(out) ** 0.5))
        ps = [np.asarray(p) for p in out]  # u^2 x (3, H/u, W/u)
        if extras.get("validate"):
            from .io.png import weave_grid_host

            rc = _validate(
                img, np.moveaxis(weave_grid_host(ps, u), 0, -1), plan
            )
        from .io.png import write_png_planar_grid

        write_png_planar_grid(out_path, ps, u)
    elif fmt == "rows":
        e_np, d_np = (np.asarray(p) for p in out)  # each (3, H/2, W)
        if extras.get("validate"):
            woven = np.stack([e_np, d_np], axis=2).reshape(3, plan.H, plan.W)
            rc = _validate(img, np.moveaxis(woven, 0, -1), plan)
        from .io.png import write_png_planar_parity

        write_png_planar_parity(out_path, e_np, d_np)
    else:
        out_np = np.asarray(out)  # (3, H, W)
        if extras.get("validate"):
            rc = _validate(img, np.moveaxis(out_np, 0, -1), plan)
        write_png_planar(out_path, out_np)
    return rc


def run_batched(cfg, extras) -> int:
    import numpy as np
    import jax

    from .io.folder import frame_paths
    from .io.png import PngPool, read_png
    from .pipeline.batched import build_batched_upscale

    import os as _os

    in_paths = frame_paths(cfg.ifolder_prefix, cfg.num_files)
    out_paths = frame_paths(cfg.ofolder_prefix or cfg.ifolder_prefix, cfg.num_files)
    if extras.get("resume"):
        # checkpoint/resume by file index (the %06d.png protocol makes the
        # batch trivially resumable — the reference tracked nothing,
        # SURVEY §5.4)
        keep = [i for i, p in enumerate(out_paths) if not _os.path.exists(p)]
        skipped = cfg.num_files - len(keep)
        if skipped:
            print(f"Resume: skipping {skipped} already-upscaled frames")
        in_paths = [in_paths[i] for i in keep]
        out_paths = [out_paths[i] for i in keep]
        if not in_paths:
            print("Resume: nothing to do")
            return 0

    try:
        first = read_png(in_paths[0])
    except FileNotFoundError:
        print("Image not found")
        return 1
    h, w = first.shape[:2]
    plan = _make_plan(cfg, extras, h, w)
    print(f"Device memory per device: {_hbm_estimate_mb(plan)} MB")

    n_dev = jax.device_count()
    mesh = None
    if n_dev > 1:
        from .parallel.mesh import data_parallel_mesh

        mesh = data_parallel_mesh()
    n_files = len(in_paths)
    batch = extras["batch"] or max(n_dev, min(8, n_files))
    # round batch to a device multiple for even sharding
    if mesh is not None:
        batch = max(n_dev, (batch // n_dev) * n_dev)
    # planar device output + native planar encode: no layout transpose on
    # either side of the PNG boundary.  u=2 plans emit parity planes and
    # the encoder's row loop interleaves them for free.
    from .pipeline.upscale import planes_format

    fmt = planes_format(plan)
    fn = build_batched_upscale(
        plan, mesh, planar_out=True, planes_out=fmt is not None
    )

    t0 = time.perf_counter()
    done = 0
    with PngPool(cfg.num_threads) as pool:
        idx = 0
        pending = None  # (out_paths_chunk, device_result)
        while idx < n_files or pending is not None:
            # decode next chunk while the device works on the previous one
            chunk = in_paths[idx : idx + batch]
            next_out = out_paths[idx : idx + batch]
            imgs = None
            if chunk:
                imgs = pool.decode_batch(chunk, w, h)
                n = imgs.shape[0]
                if n < batch:  # pad the tail to the compiled batch shape
                    pad = np.zeros((batch - n, h, w, 3), np.uint8)
                    imgs = np.concatenate([imgs, pad], 0)
            if pending is not None:
                paths_prev, res_prev, n_prev = pending
                if fmt == "quad":
                    ps = [np.asarray(p)[:n_prev] for p in res_prev]
                    pool.encode_batch_planar_parity4(paths_prev, ps)
                elif fmt == "grid":
                    ps = [np.asarray(p)[:n_prev] for p in res_prev]
                    pool.encode_batch_planar_grid(
                        paths_prev, ps, int(round(len(ps) ** 0.5))
                    )
                elif fmt == "rows":
                    e_np = np.asarray(res_prev[0])[:n_prev]
                    d_np = np.asarray(res_prev[1])[:n_prev]
                    pool.encode_batch_planar_parity(paths_prev, e_np, d_np)
                else:
                    out_np = np.asarray(res_prev)[:n_prev]
                    pool.encode_batch_planar(paths_prev, out_np)
                done += n_prev
                pending = None
            if imgs is not None:
                res = fn(imgs)
                pending = (next_out, res, len(chunk))
            idx += batch
    dt = time.perf_counter() - t0
    print(
        "Upscaled %d frames %dx%d -> %dx%d in %0.3f s (%0.2f frames/s)"
        % (done, w, h, plan.W, plan.H, dt, done / dt if dt > 0 else 0.0)
    )
    # completion line with device name (reference: "Thread %d finished.
    # Device name: %s API:...", VkResample.cpp:1773)
    kind = getattr(jax.devices()[0], "device_kind", "unknown")
    print(f"Finished. Device name: {kind} ({n_dev} device(s))")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from . import __version__

    if find_flag(argv, "-h") or not argv:
        print(HELP.format(version=__version__))
        return 0
    if find_flag(argv, "-devices"):
        from .parallel.mesh import device_list_string

        print(device_list_string())
        return 0

    parsed = _parse(argv)
    if parsed is None:
        return 1
    cfg, extras = parsed
    print("vkresample-tpu - FFT based upscaling")
    from .io.png import codec_name

    try:
        codec_name()
    except RuntimeError as e:
        print(f"Error: {e}")
        return 1
    from .core.bankcache import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.perf_counter()
    try:
        if cfg.file_upload:
            rc = run_batched(cfg, extras)
        else:
            rc = run_single(cfg, extras)
    except ValueError as e:
        # plan/geometry errors (non-7-smooth dims, unsupported factors):
        # clean message like the reference's scheduler error paths
        # (vkFFT.h:4726 prints and aborts, no stack dump)
        print(f"Error: {e}")
        return 1
    print("Total time: %0.3f s" % (time.perf_counter() - t0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
