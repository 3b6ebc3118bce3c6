"""Device-side benchmark harness.

time_device runs a SINGLE device program containing a ``lax.fori_loop``
of K pipeline iterations with a data dependency chained through the loop
carry (so XLA cannot hoist or parallelize them), forces completion with
a scalar readback, and removes one-time costs (program launch, readback
latency) by measuring two loop lengths and taking the difference
quotient: t_per_iter = (T(k2) - T(k1)) / (k2 - k1).

This reproduces the reference's ``-n`` semantics — X pipeline repeats per
submit, one sync (VkResample.cpp:1249-1279) — with the repeats inside one
XLA program (the analog of recording X iterations into one command
buffer) and a forced result fetch as the fence.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def make_looped(pipeline: Callable) -> Callable:
    """Wrap a pipeline(x, aux) -> u8-image into run(x, aux, k) -> scalar
    that executes the pipeline k times serially on-device.  `aux` carries
    constant operands (e.g. DFT banks) as jit arguments, not HLO literals."""

    def run(x, aux, k):
        zero_in = (0,) * x.ndim  # rank-generic single-element probe

        def body(i, carry):
            # perturb one pixel with the carry so iteration i+1 depends on
            # iteration i's output — forbids hoisting/parallelizing
            xi = x.at[zero_in].set(carry.astype(x.dtype))
            # the barrier makes every output exist in full: without it
            # XLA sinks the one-element probe below into the elementwise
            # and stencil fusions and computes a few pixels per frame
            out = jax.lax.optimization_barrier(pipeline(xi, aux))
            return sum(
                leaf[(0,) * leaf.ndim].astype(jnp.int32)
                for leaf in jax.tree_util.tree_leaves(out)
            )

        c = jax.lax.fori_loop(0, k, body, x[zero_in].astype(jnp.int32))
        return c

    return jax.jit(run)


def time_device(
    pipeline: Callable, x, aux=None, k1: int = 4, k2: int = 20, reps: int = 1
) -> float:
    """Returns ms per pipeline iteration, launch/readback overhead removed.

    reps > 1 repeats each loop-length measurement and uses the MIN of the
    t1s and the MIN of the t2s in ONE difference quotient: host noise
    (scheduling, other processes) only ever adds time, so per-measurement
    minima cancel it, whereas min-of-quotients would be biased low (a
    stall inside a k1 measurement deflates that rep's quotient and the
    min would select exactly the corrupted rep)."""
    run = make_looped(pipeline)

    def measure(k) -> float:
        t0 = time.perf_counter()
        v = run(x, aux, k)
        int(v)  # forced scalar readback = real completion fence
        return time.perf_counter() - t0

    measure(k1)  # compile (k is traced) + warm path
    t1 = min(measure(k1) for _ in range(max(1, reps)))
    t2 = min(measure(k2) for _ in range(max(1, reps)))
    return max(t2 - t1, 1e-9) * 1000.0 / (k2 - k1)
