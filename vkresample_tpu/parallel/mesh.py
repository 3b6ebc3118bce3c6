"""Device mesh + sharding helpers.

Parallelism design (SURVEY §2.4): the reference's only parallelism is
frame-level data parallelism — N CPU threads, each with its own Vulkan
device, round-robin over files (VkResample.cpp:1958-1969).  The
equivalent here shards the frame batch across devices over a flat 1-D
"dp" mesh with per-device FFTs and ZERO collectives on the hot path; only
the host-side scatter/gather moves frames, and it stays off the timed
region exactly like PNG I/O does in the reference.

An optional "sp" axis supports pencil-decomposed distributed FFTs for
frames too large for one device (see parallel/distributed.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_parallel_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'dp'."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), axis_names=("dp",))


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (N, h, w, C) frame batch over the dp axis, leading dim."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def device_list_string() -> str:
    """Pretty device list (the reference's -devices printer,
    VkResample.cpp:239-268 prints 'Device id: N name: X API:x.y.z')."""
    lines = []
    for i, d in enumerate(jax.devices()):
        kind = getattr(d, "device_kind", "unknown")
        platform = getattr(d, "platform", "unknown")
        lines.append(
            f"Device id: {i} name: {kind} platform: {platform} "
            f"jax:{jax.__version__}"
        )
    return "\n".join(lines)
