"""bench.py outlier-rejection policy.

bench.py discards implausibly low readings (under ARTIFACT_FRACTION x the
tier's max) before taking the median and schedules extra interleaved
passes when a tier is left without three plausible agreeing readings, so
a recorded number can never silently carry a reading the process could
not reproduce.  These tests pin that policy (pure host logic — no jax
involved).
"""
from __future__ import annotations

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "bench", pathlib.Path(__file__).resolve().parent.parent / "bench.py"
)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def test_plausible_drops_low_artifacts_only():
    # near-zero outliers vanish; genuine few-percent spread survives
    assert bench._plausible([0.0, 0.0, 1.3]) == [1.3]
    assert bench._plausible([24.7, 25.5, 25.1]) == [24.7, 25.5, 25.1]
    # a partial low outlier above the 0.45x cut is still rejected by the
    # median as a minority reading
    assert bench._robust_value([0.71, 1.23, 1.37]) == 1.23


def test_robust_value_median_or_min():
    assert bench._robust_value([1.31, 1.23, 1.37]) == 1.31  # median of 3
    assert bench._robust_value([0.0, 0.0, 1.3]) == 1.3      # min of survivors
    assert bench._robust_value([0.0, 2.36, 1.2]) == 1.2


def test_unstable_triggers_extra_passes():
    # stable big-tier spread: no extra work
    assert not bench._unstable([25.1, 24.7, 25.5])
    assert not bench._unstable([1.23, 1.31, 1.37])
    # outliers ate the pass budget / wide plausible spread / all-zero
    assert bench._unstable([0.0, 0.0, 1.3])
    assert bench._unstable([0.0, 2.36, 1.2])
    assert bench._unstable([0.0, 0.0, 0.0])
    # a wildly spread set of passes must be flagged, not committed as-is
    assert bench._unstable([0.0, 1.1, 2.36])


def test_warmup_outlier_resolves_with_extra_pass():
    # a lone slow pass-1 warmup reading asks for one extra pass ...
    assert bench._unstable([2.0, 1.25, 1.23])
    # ... and once 3 readings agree within the band, the tier is stable
    # despite the outlier still being in the list (max/min spread rules
    # would flag this forever)
    assert not bench._unstable([2.0, 1.25, 1.23, 1.22])
    assert abs(bench._robust_value([2.0, 1.25, 1.23, 1.22]) - 1.24) < 1e-9


def test_policy_constants():
    # the thresholds are part of the recorded protocol (bench.py
    # docstring); changing them should be a conscious act
    assert bench.ARTIFACT_FRACTION == 0.45
    assert bench.AGREE_BAND == 0.3
    assert bench.EXTRA_PASSES == 2
