"""Batched upscale: vmapped single-frame pipeline, optionally sharded over
a device mesh (frame data parallelism, zero collectives on the hot path —
SURVEY §2.4 / BASELINE north star)."""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core.plan import UpscalePlan
from ..parallel import mesh as mesh_lib
from .upscale import _pipeline


@functools.lru_cache(maxsize=32)
def build_batched_upscale(
    plan: UpscalePlan,
    mesh: Optional[jax.sharding.Mesh] = None,
    planar_out: bool = False,
    planes_out: bool = False,
) -> Callable:
    """(N, h, w, C) uint8 -> (N, H, W, C) uint8 (or (N, C, H, W) planar;
    with planes_out, a pair of (N, C, H/2, W) parity planes), one jitted
    program.

    With a mesh, frames shard over the 'dp' axis and the pipeline runs
    under shard_map: each device runs its own per-frame pipeline on its
    local frames (no collectives, matching the reference's independent
    per-thread Vulkan devices), so opaque kernels such as the GPU CAS
    kernel are never gathered onto one device.  The batch must divide
    over the mesh.
    """
    from .upscale import make_device_banks

    engine = plan.resolve_engine()
    banks = make_device_banks(plan, engine, planes=planes_out)
    # _pipeline is batch-polymorphic over leading dims (vmap would hit the
    # pallas_call batching rule, which can't handle ANY-memspace refs)
    fn = functools.partial(
        _pipeline,
        plan=plan,
        engine=engine,
        planar_out=planar_out,
        planes_out=planes_out,
    )
    if mesh is None:
        jitfn = jax.jit(fn)
    else:
        sh = mesh_lib.frames_sharding(mesh)
        rep = mesh_lib.replicated(mesh)
        banks_sh = None if banks is None else jax.tree.map(lambda _: rep, banks)
        # replicate once here, not on every call
        banks = None if banks is None else jax.device_put(banks, banks_sh)
        frames = jax.sharding.PartitionSpec("dp")
        local = jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(frames, jax.tree.map(lambda _: jax.sharding.PartitionSpec(), banks)),
            # a pytree prefix: applies to every output leaf (woven array,
            # or the 2/4/u^2 parity planes)
            out_specs=frames,
            # the body has no collectives; the kernels' out_shapes carry
            # no varying-axis annotation
            check_vma=False,
        )
        jitfn = jax.jit(local, in_shardings=(sh, banks_sh), out_shardings=sh)

    def run(imgs, _fn=jitfn, _banks=banks):
        return _fn(imgs, _banks)

    return run


def upscale_batch(imgs, plan: UpscalePlan, mesh=None):
    """Convenience wrapper: batch of uint8 frames -> upscaled batch."""
    imgs = jnp.asarray(imgs)
    if imgs.dtype != jnp.uint8 or imgs.ndim != 4:
        raise TypeError(f"expected (N, h, w, C) uint8, got {imgs.shape} {imgs.dtype}")
    return build_batched_upscale(plan, mesh)(imgs)
