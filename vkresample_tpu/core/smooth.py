"""7-smooth size planning.

The reference's scheduler factorizes every FFT axis into primes {2,3,5,7}
and errors on anything else (vkFFT.h:4716-4726; CLI help VkResample.cpp:1813).
It then groups prime factors into butterfly radixes {8,4,2,3,5,7} per pass
(vkFFT.h:5022-5186).

Here the planning question is different: each FFT stage is a batched
(factor x factor) DFT-matrix contraction on the matrix units, so prime
factors are grouped into *composite* mixed-radix factors as close to 128
as possible.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

_SMOOTH_PRIMES = (2, 3, 5, 7)


def factorize_7smooth(n: int) -> List[int]:
    """Prime factorization into {2,3,5,7}; raises on other primes.

    Semantics of vkFFT.h:4716-4726 ("sequence length exceeds the prime
    factorization limit").
    """
    if n < 1:
        raise ValueError(f"size must be >= 1, got {n}")
    factors: List[int] = []
    m = n
    for p in _SMOOTH_PRIMES:
        while m % p == 0:
            factors.append(p)
            m //= p
    if m != 1:
        raise ValueError(
            f"size {n} is not 7-smooth (leftover prime factor {m}); "
            "output dimensions must be products of 2, 3, 5 and 7"
        )
    return factors


def is_7smooth(n: int) -> bool:
    try:
        factorize_7smooth(n)
        return True
    except ValueError:
        return False


@lru_cache(maxsize=None)
def plan_factors(n: int, max_factor: int = 128) -> Tuple[int, ...]:
    """Split n into 7-smooth composite factors, each <= max_factor.

    Greedy largest-first: repeatedly peel off the largest divisor of the
    remaining size that is <= max_factor.  This minimizes the number of FFT
    stages (each stage = one DFT-matrix contraction + one twiddle multiply)
    while keeping every DFT matrix within one MXU tile.

    Examples (max_factor=128):
        2048 -> (128, 16)
        4096 -> (128, 32)
        1024 -> (128, 8)
        3072 -> (128, 24)
        5040 -> (126, 40)
    """
    factorize_7smooth(n)  # validate
    if n == 1:
        return (1,)
    out: List[int] = []
    m = n
    while m > 1:
        if m <= max_factor:
            out.append(m)
            break
        best = 1
        for d in range(min(max_factor, m), 1, -1):
            if m % d == 0:
                best = d
                break
        if best == 1:  # cannot happen for 7-smooth m > max_factor >= 7
            raise ValueError(f"cannot factor {n} with max_factor={max_factor}")
        out.append(best)
        m //= best
    # Largest-first ordering (mirrors vkFFT.h:5173-5186 emitting stageRadix
    # largest-first) keeps the biggest matmul on the most data-local stage.
    out.sort(reverse=True)
    return tuple(out)
