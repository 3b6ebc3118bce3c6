"""Disk caches for plan-time bank pytrees and compiled executables.

Big-geometry bank construction is seconds to minutes of host numpy —
fine for a resident server that builds once, painful for one-shot CLI
runs.  The reference has no equivalent cost (VkFFT uploads LUTs computed
in milliseconds, vkFFT.h:6157-6308), so this build hides it behind a
versioned on-disk cache: the second CLI invocation at the same geometry
skips staging entirely.

Layout: one .npz per bank set under $VKRESAMPLE_CACHE_DIR (default
<checkout>/.cache, listed in .gitignore), keyed by a hash of (cache
version, builder tag, plan geometry, dtype, and every env knob that
changes bank CONTENTS).  bfloat16 arrays (no portable numpy
serialization) ride as uint16 views with a JSON dtype manifest.  Writes
are atomic (tmp + rename) and any unreadable entry falls back to a
rebuild, so the cache can never produce worse results than no cache.
VKRESAMPLE_NO_BANK_CACHE=1 disables.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Callable, Dict

import numpy as np

# bump when any bank builder's MATH changes (contents for the same key)
# v3: staged conv_banks actually inherits the balanced n1<=64 split
#     default (v2 intended this but conv_banks' own prefer=128 won)
# v5: staged banks carry dc0 kernel DC gains (bf16c)
# v7: staged x (lanes) convs prefer n1 = 128*q (128-exact minor dims
#     at the x->y boundary)
# v8: x prefer additionally doubles until n2 <= 64 (the w=16384
#     boundary relayouts)
CACHE_VERSION = 8

# cache only geometries where host staging is actually noticeable; small
# banks rebuild in well under a second and aren't worth the disk churn
MIN_CACHED_DIM = 4096

# env knobs that change bank CONTENTS (not just route selection) — part
# of the key so a knob flip can never serve stale banks
_CONTENT_KNOBS = (
    "VKRESAMPLE_NO_INT8",
    "VKRESAMPLE_HALF_STORAGE",
    "VKRESAMPLE_MM_PRECISION",
    "VKRESAMPLE_Y_DIGITS",
    "VKRESAMPLE_XSPLIT",
    "VKRESAMPLE_YSPLIT",
)


# the checkout this package lives in: caches stay inside it
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    return os.environ.get("VKRESAMPLE_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".cache"
    )


def enable_compilation_cache() -> None:
    """Persist compiled XLA executables across processes, so the second
    run of the same plan geometry loads its executables from disk instead
    of compiling (the reference pays milliseconds of glslang per shader,
    SURVEY §1).  Keying (jax/backend versions, HLO, flags) is jax's own.

    Where JAX_COMPILATION_CACHE_DIR is set, jax already uses it and this
    sets nothing.  Otherwise the cache lives at the fixed path
    cache_dir()/xla: the directory is part of the cache's key, so it must
    not move between runs.  VKRESAMPLE_NO_COMPILE_CACHE=1 disables."""
    if os.environ.get("VKRESAMPLE_NO_COMPILE_CACHE") or os.environ.get(
        "JAX_COMPILATION_CACHE_DIR"
    ):
        return
    import jax

    d = os.path.join(cache_dir(), "xla")
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)


def _key(tag: str, plan, dtype: str) -> str:
    knobs = {k: os.environ.get(k, "") for k in _CONTENT_KNOBS}
    blob = json.dumps(
        [
            CACHE_VERSION,
            tag,
            plan.h,
            plan.w,
            float(plan.upscale),
            plan.precision.name,
            bool(plan.r2c),
            dtype,
            knobs,
        ],
        sort_keys=True,
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _save(path: str, banks: Dict[str, np.ndarray]) -> None:
    manifest = {}
    payload = {}
    for k, v in banks.items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            manifest[k] = "bfloat16"
            a = a.view(np.uint16)
        payload[k] = a
    payload["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path), suffix=".npz.tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load(path: str) -> Dict[str, np.ndarray]:
    import ml_dtypes

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        banks = {}
        for k in z.files:
            if k == "__manifest__":
                continue
            a = z[k]
            if manifest.get(k) == "bfloat16":
                a = a.view(ml_dtypes.bfloat16)
            banks[k] = a
    return banks


def get_or_build(
    tag: str, plan, dtype: str, build: Callable[[], Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """Return the bank dict for (tag, plan, dtype), from disk when a
    valid cached entry exists, rebuilding (and caching) otherwise."""
    if os.environ.get("VKRESAMPLE_NO_BANK_CACHE") or (
        max(plan.h, plan.w, plan.H, plan.W) < MIN_CACHED_DIM
    ):
        return build()
    path = os.path.join(cache_dir(), f"{tag}-{_key(tag, plan, dtype)}.npz")
    if os.path.exists(path):
        try:
            return _load(path)
        except Exception:
            # unreadable/corrupt/foreign entry: rebuild and overwrite
            pass
    banks = build()
    try:
        _save(path, banks)
    except OSError:
        pass  # read-only disk/quota: the cache is best-effort
    return banks
