"""The control at a size a test run holds: the reference in TF32 in the
program's place reads above each cell's limit and is judged not correct
by the harness's own ``judge``, the program below it and correct."""
from __future__ import annotations

import pytest

from bench import testing


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return testing.tiny_layout(tmp_path_factory.mktemp("layout"))


@pytest.mark.parametrize("cell", ["mk-tiny.fresh", "mk-tiny.revisit"])
def test_the_control_fails_the_limits_the_program_keeps(layout, cell):
    r = testing.control(layout, cell, 2**35 + 17, 0.5)
    limits = r["limits"]
    assert r["compared"] > 0 and set(r["program"]) == set(limits), r
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > 3 * limits[k] for k in limits), r
    assert r["program_correct"] is True and r["control_correct"] is False
