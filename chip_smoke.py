"""Smoke run of the upscaler on one NVIDIA GPU, through the entry points a
user calls, at the reference's real frame sizes.

    python chip_smoke.py          # one card: CLI, batched CLI, library
                                  # tiers, CAS vs reference, memory
    python chip_smoke.py --multi  # every card of the host: the dp batched
                                  # path and the sp staged pencil, each
                                  # against the one-card pipeline

Every output is checked against the fp64 NumPy oracle (oracle/numpy_ref.py)
at <= 1 uint8 LSB; the big tiers check one channel to bound host time.
Each phase prints its route (planes_format), maxdiff, the share of pixels
that differ, and device ms per frame (pipeline/bench_util.time_device)
beside the card's name and power limit.  Any failed check raises, and the
run exits non-zero.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The run refuses to start without a GPU: it never falls back to the CPU
and never runs a kernel in interpret mode.  It drives the card from this
one process.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".cache", "chip_smoke")
T0 = time.perf_counter()

# frame sizes (h, w) of each phase: the reference's headline frame and the
# other sizes bench.py times
SIZES = {
    "flagship": (1024, 2048),
    "big": (4096, 8192),  # 8K -> 16K staged quad; also the sp pencil
    "grid": (2048, 4096),  # u=3 -> 6144x12288
    "mem_big": (8192, 16384),  # 16K -> 32K, 3 channels (compiled only)
}
SAMPLE = os.path.join(ROOT, "samples", "test_1920x1080.png")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    """name, power.limit of GPU 0 as nvidia-smi reports them (a child
    process that does not import JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def bytes_in_use(dev) -> int:
    return dev.memory_stats()["bytes_in_use"]


def require_gpu(devs) -> None:
    if devs[0].platform != "gpu":
        fail(f"no GPU: jax.devices()[0].platform == {devs[0].platform!r}")


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def main(argv) -> int:
    multi = "--multi" in argv
    import jax

    devs = jax.devices()
    require_gpu(devs)
    sys.path.insert(0, ROOT)
    import numpy as np

    import vkresample_tpu  # noqa: F401  (fails clean outside the repo)
    from vkresample_tpu.io.png import codec_name

    card = card_line()
    log(f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"card: {card}")
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    log(f"PNG codec: {codec_name()}")
    os.makedirs(WORK, exist_ok=True)
    ctx = Smoke(card, np.random.default_rng(20261016))
    if multi:
        if len(devs) < 2:
            fail(f"--multi needs several GPUs, found {len(devs)}")
        ctx.multi()
    else:
        ctx.cli_single()
        ctx.cli_batched()
        ctx.library_tiers()
        ctx.cas_vs_reference()
        ctx.memory()
    log(f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs) if multi else 1,
    }}), flush=True)
    return 0


class Smoke:
    def __init__(self, card, rng):
        self.card = card
        self.rng = rng

    # ------------------------------------------------------------ helpers
    def compare(self, name, got, want, tol=1):
        """maxdiff and differing share of two uint8 images; raises past
        tol."""
        import numpy as np

        if got.shape != want.shape:
            fail(f"{name}: shape {got.shape} != {want.shape}")
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        md, share = int(d.max()), float((d > 0).mean())
        if md > tol:
            fail(f"{name}: maxdiff {md} > {tol} LSB (share {share:.3e})")
        return md, share

    def oracle(self, img, plan, channels=None):
        """fp64 oracle (H, W, c) for the first `channels` channels."""
        from vkresample_tpu.oracle.numpy_ref import upscale_oracle

        c = img.shape[-1] if channels is None else channels
        return upscale_oracle(img[:, :, :c], plan)

    def ms(self, plan, planes_out, planar_out=True, k1=4, k2=20):
        """Device ms per frame of the pipeline this plan runs."""
        import jax
        import numpy as np

        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.pipeline.bench_util import time_device
        from vkresample_tpu.pipeline.upscale import _pipeline, make_device_banks

        x64 = plan.precision is Precision.DOUBLE
        with jax.enable_x64(x64):
            eng = plan.resolve_engine()
            banks = make_device_banks(plan, eng, planes=planes_out)
            fn = functools.partial(
                _pipeline, plan=plan, engine=eng, planar_out=planar_out,
                planes_out=planes_out,
            )
            x = jax.device_put(
                self.rng.integers(0, 256, (plan.h, plan.w, plan.channels), np.uint8)
            )
            return time_device(fn, x, aux=banks, k1=k1, k2=k2, reps=2)

    def report(self, phase, route, md, share, ms=None, extra=""):
        t = "not timed" if ms is None else f"{ms:.4f} ms/frame"
        log(f"{phase}: route={route} maxdiff={md} differing={share:.3e} "
            f"{t} [{self.card}] {extra}".rstrip())

    def run_cli(self, args):
        """vkresample's main() in this process; returns (rc, stdout)."""
        from vkresample_tpu import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(args))
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"  | {line}")
        return rc, out

    # ------------------------------------------------------------- phases
    def cli_single(self):
        """Phase 1: `vkresample -i -o -u 2 -p 2 -s 0.2 -n 10 -validate`."""
        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.io.png import read_png, write_png
        from vkresample_tpu.pipeline.upscale import planes_format

        src = os.path.join(WORK, "in_flagship.png")
        write_png(src, self.rng.integers(0, 256, SIZES["flagship"] + (3,), "uint8"))
        for name, path in (("cli flagship", src), ("cli sample", SAMPLE)):
            img = read_png(path)
            H, W = 2 * img.shape[0], 2 * img.shape[1]
            plan = UpscalePlan(h=img.shape[0], w=img.shape[1], upscale=2.0,
                               precision=Precision.HALF, sharpen=0.2)
            route = planes_format(plan)
            if route != "quad":
                fail(f"{name}: route {route!r}, want 'quad'")
            out = os.path.join(WORK, f"out_{W}x{H}.png")
            rc, text = self.run_cli(["-i", path, "-o", out, "-u", "2", "-p", "2",
                                     "-s", "0.2", "-n", "10", "-validate"])
            if rc != 0 or "OK" not in text:
                fail(f"{name}: CLI rc {rc}")
            got = read_png(out)
            if got.shape != (H, W, 3):
                fail(f"{name}: output PNG {got.shape}, want {(H, W, 3)}")
            md, share = self.compare(name, got, self.oracle(img, plan))
            self.report(name, route, md, share, self.ms(plan, True))

    def cli_batched(self):
        """Phase 2: `-ifolder -ofolder -numfiles 8 -numthreads 4 -u 2 -p 2`."""
        import numpy as np

        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.io.png import read_png, write_png
        from vkresample_tpu.pipeline.upscale import planes_format

        base = read_png(SAMPLE)
        ind, outd = os.path.join(WORK, "bin"), os.path.join(WORK, "bout")
        os.makedirs(ind, exist_ok=True)
        os.makedirs(outd, exist_ok=True)
        frames = []
        for i in range(8):
            f = np.roll(base, 37 * i, axis=1)
            frames.append(f)
            write_png(os.path.join(ind, "%06d.png" % (i + 1)), f)
            out = os.path.join(outd, "%06d.png" % (i + 1))
            if os.path.exists(out):
                os.unlink(out)
        rc, text = self.run_cli([
            "-ifolder", ind, "-ofolder", outd,
            "-numfiles", "8", "-numthreads", "4", "-u", "2", "-p", "2",
        ])
        if rc != 0:
            fail(f"batched CLI rc {rc}")
        for i in range(8):
            if not os.path.exists(os.path.join(outd, "%06d.png" % (i + 1))):
                fail(f"batched CLI wrote no frame {i + 1}")
        plan = UpscalePlan(h=base.shape[0], w=base.shape[1], upscale=2.0,
                           precision=Precision.HALF, sharpen=0.2)
        got = read_png(os.path.join(outd, "000005.png"))
        md, share = self.compare("batched frame 5", got, self.oracle(frames[4], plan))
        rate = [l for l in text.splitlines() if "frames/s" in l]
        self.report(f"cli batched 8x{base.shape[1]}x{base.shape[0]}", planes_format(plan), md, share,
                    extra=(rate[0].strip() if rate else ""))

    def library_tiers(self):
        """Phase 3: the library entry point and every other tier, at the
        sizes bench.py uses."""
        import jax
        import numpy as np

        import vkresample_tpu as vkr
        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.io.png import weave_grid_host
        from vkresample_tpu.pipeline.upscale import build_upscale, planes_format

        H = Precision.HALF
        F, B, G = SIZES["flagship"], SIZES["big"], SIZES["grid"]
        tiers = [
            # name, (h, w), plan kwargs, oracle channels, timing loop
            ("woven half (library upscale)", F, dict(upscale=2.0, precision=H), 3, None),
            ("fp32 single", F, dict(upscale=2.0, precision=Precision.SINGLE), 3, (4, 20)),
            ("c2c", F, dict(upscale=2.0, precision=H, r2c=False), 3, (4, 20)),
            ("u1.5", F, dict(upscale=1.5, precision=H), 3, (4, 20)),
            ("big staged quad", B, dict(upscale=2.0, precision=H), 1, (2, 6)),
            ("u3 grid", G, dict(upscale=3.0, precision=H), 1, (2, 6)),
            ("-p 1 double", F, dict(upscale=2.0, precision=Precision.DOUBLE), 3, (2, 8)),
        ]
        for name, (h, w), kw, nch, loop in tiers:
            img = self.rng.integers(0, 256, (h, w, 3), np.uint8)
            plan = UpscalePlan(h=h, w=w, sharpen=0.2, **kw)
            if loop is None:
                # the public convenience entry: woven (H, W, C) output
                got = np.asarray(vkr.upscale(img, plan.upscale, plan=plan))
                route = "woven"
                ms = self.ms(plan, False, planar_out=False)
            else:
                fmt = planes_format(plan)
                fn = build_upscale(plan, planar_out=True, planes_out=fmt is not None)
                out = fn(jax.device_put(img))
                if fmt is None:
                    got = np.moveaxis(np.asarray(out), 0, -1)
                else:
                    ps = [np.asarray(p) for p in out]
                    u = int(round(len(ps) ** 0.5)) if fmt != "rows" else None
                    if fmt == "rows":
                        got = np.stack(ps, axis=2).reshape(3, plan.H, plan.W)
                    else:
                        got = weave_grid_host(ps, u)
                    got = np.moveaxis(got, 0, -1)
                route = fmt or "woven"
                ms = self.ms(plan, fmt is not None, k1=loop[0], k2=loop[1])
            want = self.oracle(img, plan, nch)
            md, share = self.compare(name, got[:, :, :nch], want)
            self.report(name, route, md, share, ms,
                        extra=f"({h}x{w} -> {plan.H}x{plan.W}, {nch} ch vs oracle)")

    def cas_vs_reference(self):
        """Phase 4: the plain parity-plane CAS and the GPU kernel vs
        ops/cas.py's woven CAS on the same pre-CAS planes, at the flagship
        and 8K plane sizes, then the two timed against each other alone
        and inside the whole frame (interleaved plain, kernel, kernel,
        plain)."""
        import unittest.mock

        import jax
        import jax.numpy as jnp
        import numpy as np

        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.io.png import weave4_host
        from vkresample_tpu.ops import cas as cas_ops
        from vkresample_tpu.ops import cas_triton
        from vkresample_tpu.pipeline import upscale as up
        from vkresample_tpu.pipeline.bench_util import time_device

        def plain(p, aux=None):
            return cas_ops.cas_parity_planes(list(p), 0.2, 2)

        def kernel(p, aux=None):
            return cas_triton.cas_parity_planes_triton(list(p), 0.2, 2)

        for name in ("flagship", "big"):
            shape = (3,) + SIZES[name]
            v = self.rng.random((4,) + shape, np.float32) * 1.3 - 0.1
            xs = cas_ops.to_i16_storage(jnp.asarray(v))

            def woven(p):
                f = [cas_ops.clip_unit(t) for t in p]
                v4 = jnp.stack([jnp.stack([f[0], f[1]], -1),
                                jnp.stack([f[2], f[3]], -1)], -3)
                v4 = v4.reshape(shape[0], 2 * shape[1], 2 * shape[2])
                return cas_ops.quantize_u8(cas_ops.cas_sharpen(v4, 0.2))

            want = np.asarray(jax.jit(woven)(xs))
            for impl, fn in (("plain", plain), ("kernel", kernel)):
                got = weave4_host(*[np.asarray(o) for o in jax.jit(fn)(xs)])
                md, share = self.compare(f"{impl} CAS {name}", got, want)
                log(f"cas {name} planes {shape}x4 int16: {impl} vs woven CAS "
                    f"maxdiff={md} differing={share:.3e}")
            cas_ms = {"plain": [], "kernel": []}
            for impl in ("plain", "kernel", "kernel", "plain"):
                fn = plain if impl == "plain" else kernel
                cas_ms[impl].append(time_device(fn, xs, k1=4, k2=24, reps=3))

            # the whole frame, with the pipeline's quad CAS as it ships
            # (the kernel on CUDA) and with the plain function in its place
            h, w = SIZES[name]
            plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF,
                               sharpen=0.2)
            k1, k2 = (4, 20) if name == "flagship" else (2, 6)
            e2e = {"plain": [], "kernel": []}
            for impl in ("plain", "kernel", "kernel", "plain"):
                if impl == "plain":
                    with unittest.mock.patch.object(
                        up, "cas_quad_planes",
                        lambda ps, s: cas_ops.cas_parity_planes(ps, s, 2),
                    ):
                        e2e[impl].append(self.ms(plan, True, k1=k1, k2=k2))
                else:
                    e2e[impl].append(self.ms(plan, True, k1=k1, k2=k2))
            fmt = lambda xs: "/".join(f"{x:.4f}" for x in xs)  # noqa: E731
            log(f"cas {name}: CAS alone plain {fmt(cas_ms['plain'])} ms, kernel "
                f"{fmt(cas_ms['kernel'])} ms; whole frame ({h}x{w} -> "
                f"{2 * h}x{2 * w}) plain {fmt(e2e['plain'])} ms, kernel "
                f"{fmt(e2e['kernel'])} ms [{self.card}]")

    def memory(self):
        """Phase 5: memory_analysis() of the flagship and the 3-channel
        16K->32K programs (compiled, not run)."""
        import jax
        import numpy as np

        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.pipeline.upscale import (
            CHANNEL_SERIAL_ELEMS, _channel_serial, _pipeline, make_device_banks,
            planes_format,
        )

        for name in ("flagship", "mem_big"):
            h, w = SIZES[name]
            plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF,
                               sharpen=0.2)
            fmt = planes_format(plan)
            banks = make_device_banks(plan, plan.resolve_engine(), planes=fmt is not None)
            fn = jax.jit(functools.partial(
                _pipeline, plan=plan, engine=plan.resolve_engine(), planar_out=True,
                planes_out=fmt is not None))
            x = jax.ShapeDtypeStruct((h, w, 3), np.uint8)
            ma = fn.lower(x, banks).compile().memory_analysis()
            gb = lambda b: b / 2**30  # noqa: E731
            total = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                     + ma.temp_size_in_bytes)
            serial = _channel_serial(plan, np.zeros((1, 1, 3), np.uint8))
            log(f"memory {name} ({fmt}, channel-serial={serial}, threshold "
                f"{CHANNEL_SERIAL_ELEMS:.1e} elems): args {gb(ma.argument_size_in_bytes):.3f} "
                f"GiB, out {gb(ma.output_size_in_bytes):.3f} GiB, temp "
                f"{gb(ma.temp_size_in_bytes):.3f} GiB, total {gb(total):.3f} GiB "
                f"of the card's 80 GB [{self.card}]")

    # ---------------------------------------------------------- multi-card
    def multi(self):
        """--multi: dp batched frames and the sp staged pencil over every
        card, each against the one-card pipeline."""
        import jax
        import numpy as np

        from vkresample_tpu.core.config import Precision
        from vkresample_tpu.core.plan import UpscalePlan
        from vkresample_tpu.io.png import read_png, weave4_host
        from vkresample_tpu.parallel.distributed import build_sp_upscale_staged
        from vkresample_tpu.parallel.mesh import data_parallel_mesh
        from vkresample_tpu.pipeline.batched import build_batched_upscale
        from vkresample_tpu.pipeline.upscale import build_upscale, planes_format

        devs = jax.devices()
        n = len(devs)

        # (a) dp: 16 sample frames over all cards
        base = read_png(SAMPLE)
        frames = np.stack([np.roll(base, 41 * i, axis=0) for i in range(16)])
        plan = UpscalePlan(h=base.shape[0], w=base.shape[1], upscale=2.0,
                           precision=Precision.HALF, sharpen=0.2)
        fmt = planes_format(plan)
        fn = build_batched_upscale(plan, data_parallel_mesh(), planar_out=True,
                                   planes_out=True)
        # measured after the banks are placed: a rise is the frames' own
        # outputs and working set, on each card
        before = [bytes_in_use(d) for d in devs]
        out = fn(frames)
        jax.block_until_ready(out)
        during = [bytes_in_use(d) for d in devs]
        nset = len(out[0].sharding.device_set)
        if nset != n:
            fail(f"dp output spans {nset} devices, want {n}")
        if not all(b > a for a, b in zip(before, during)):
            fail(f"dp: device memory did not rise on every card: {before} -> {during}")
        one = build_upscale(plan, planar_out=True, planes_out=True)
        md = share = 0
        for i in range(16):
            a = weave4_host(*[np.asarray(p[i]) for p in out])
            b = weave4_host(*[np.asarray(p) for p in one(frames[i])])
            m, s = self.compare(f"dp frame {i}", a, b)
            md, share = max(md, m), max(share, s)
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(fn(frames))
        dp_ms = (time.perf_counter() - t0) / 3 / 16 * 1000
        log(f"multi dp: 16x{base.shape[1]}x{base.shape[0]} over {n} cards ({fmt}): maxdiff vs 1 card "
            f"{md}, max differing share {share:.3e}, output on {nset} devices, "
            f"bytes_in_use {before} -> {during}, {dp_ms:.4f} ms/frame host clock "
            f"[{self.card}]")

        # (b) sp: the staged pencil on the big frame, half precision
        h, w = SIZES["big"]
        plan = UpscalePlan(h=h, w=w, upscale=2.0, precision=Precision.HALF,
                           sharpen=0.2)
        img = self.rng.integers(0, 256, (h, w, 3), np.uint8)
        mesh = jax.sharding.Mesh(np.array(devs), ("sp",))
        sp = build_sp_upscale_staged(plan, mesh)
        got = sp(img)
        jax.block_until_ready(got)
        nset = len(got.sharding.device_set)
        got = np.asarray(got)
        ref = np.asarray(build_upscale(plan)(img))
        md, share = self.compare("sp vs 1 card", got, ref)
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(sp(img))
        sp_ms = (time.perf_counter() - t0) / 3 * 1000
        want = self.oracle(img, plan, 1)
        mdo, shareo = self.compare("sp vs oracle", got[:, :, :1], want)
        log(f"multi sp: staged pencil {h}x{w} -> {plan.H}x{plan.W} over {nset} cards: "
            f"maxdiff vs 1 card {md} (differing {share:.3e}), vs oracle ch0 {mdo} "
            f"(differing {shareo:.3e}), {sp_ms:.4f} ms/frame host clock [{self.card}]")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
