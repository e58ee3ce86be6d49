"""Gate on the SCALING.json artifact.

The reference has no distributed mode at all (SURVEY.md §2.7: its only
parallelism is 3 OS processes + OpenMP); the build's scaling bar is
BASELINE.md's ≥70% frames/s efficiency on both sharding axes.  This test
makes the artifact itself load-bearing: valid rows must clear the bar,
and no row may claim super-unit efficiency beyond its own measured
spread (a >1.0 "efficiency" is run-to-run noise, not a result).

Skips when no artifact exists (fresh clone / CI without a bench run) or
when the artifact predates the repeats/validity schema.
"""

import json
import os

import pytest

_ART = os.path.join(os.path.dirname(__file__), os.pardir, "SCALING.json")
_BAR = 0.70  # BASELINE.md scaling acceptance bar


def _load():
    if not os.path.exists(_ART):
        pytest.skip("no SCALING.json artifact in this checkout")
    with open(_ART) as f:
        art = json.load(f)
    if "repeats" not in art:
        pytest.skip("SCALING.json predates the repeats/validity schema")
    return art


@pytest.mark.parametrize("axis", ["weak_scaling_batched",
                                  "strong_scaling_mapping"])
def test_scaling_bar_on_valid_rows(axis):
    art = _load()
    rows = art.get(axis, [])
    valid = [r for r in rows if r.get("valid")]
    assert valid, f"{axis}: no valid rows (all oversubscribed?)"
    for r in valid:
        assert r["efficiency"] >= _BAR, (
            f"{axis} devices={r['devices']}: efficiency {r['efficiency']} "
            f"below the {_BAR} bar (runs: {r.get('step_ms_runs')})"
        )


@pytest.mark.parametrize("axis", ["weak_scaling_batched",
                                  "strong_scaling_mapping"])
def test_no_superunitary_efficiency_beyond_spread(axis):
    """Super-unit efficiency is allowed only when (a) it is explained —
    the row carries the harness's work-splitting mechanism note (the
    pinned 1-core proxy's ideal assumes conserved total work, but n
    sorts of S/n keys plus the sliced ref-gather kNN genuinely shrink
    total work, bench_scaling._SUPERUNIT_NOTE) — and (b) it stays under
    the 1.5 cap beyond which no sub-linear op can be the cause.
    Unexplained or capped-out rows keep the r2-era anomaly flag and
    fail here: noise must not be published as a result."""
    art = _load()
    for r in art.get(axis, []):
        if not r.get("valid"):
            continue
        lo = r.get("efficiency_lo", r["efficiency"])
        if lo > 1.0:
            assert "superunit_note" in r, (
                f"{axis} devices={r['devices']}: efficiency lower bound "
                f"{lo} > 1.0 without a mechanism note — unexplained "
                "super-unit efficiency is noise, not a result"
            )
            assert lo <= 1.5, (axis, r["devices"], lo)
        assert "anomaly" not in r, (axis, r["devices"], r["anomaly"])


def test_rows_carry_repeat_statistics():
    art = _load()
    assert art["repeats"] >= 3
    for axis in ("weak_scaling_batched", "strong_scaling_mapping"):
        for r in art.get(axis, []):
            assert len(r["step_ms_runs"]) == art["repeats"]
            assert "valid" in r
            if not r["valid"]:
                assert r["invalid_reason"]
