"""Unit test of bench.py's headline rule: the fastest measured mode wins,
whatever its class (single-stream, chunked or aggregate lanes)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import pick_headline  # noqa: E402


@pytest.mark.parametrize("results, expected", [
    # a slower aggregate mode never outranks a faster single stream
    ({"single": {"fps": 7.73}, "batched": {"fps": 6.075}},
     ("single", 7.73)),
    # and wins when it is actually faster
    ({"single": {"fps": 7.73}, "batched": {"fps": 25.0},
      "bchunk": {"fps": 31.0}},
     ("bchunk", 31.0)),
    # a mode that produced no record is ignored
    ({"single": None, "fused": {"fps": 5.0}}, ("fused", 5.0)),
    # insertion order does not matter
    ({"bchunk": {"fps": 31.0}, "single": {"fps": 7.73}}, ("bchunk", 31.0)),
    ({}, None),
])
def test_fastest_mode_wins(results, expected):
    assert pick_headline(results) == expected
