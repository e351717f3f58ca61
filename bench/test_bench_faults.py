"""Runs of small cells with the timed path broken underneath: each must
come out not correct. The faults a serving cell can have: an answer
altered where it is produced, and part of a batch left out."""
from __future__ import annotations

import pytest

from bench import testing

ALTERED = """
from repro_torch.models import minkunet
_forward = minkunet.forward
def _altered(*args, **kw):
    out = _forward(*args, **kw).clone()
    out[0, 0] += 1e-2 * out.abs().max()
    return out
minkunet.forward = _altered
"""

HALF_TICK = """
from repro_torch.models import minkunet
_multi = minkunet.forward_multicloud
def _halved(model, clouds, **kw):
    outs = _multi(model, clouds, **kw)
    h = (len(outs) + 1) // 2
    return outs[:h] + outs[:len(outs) - h]
minkunet.forward_multicloud = _halved
"""


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return testing.tiny_layout(tmp_path_factory.mktemp("layout"))


@pytest.mark.parametrize("cell,patch", [
    ("mk-tiny.fresh", ALTERED),
    ("mk-tiny.fresh", HALF_TICK),
    ("mk-tiny.revisit", ALTERED),
    ("mk-tiny.revisit", HALF_TICK),
], ids=["altered", "half-tick", "revisit-altered", "revisit-half-tick"])
def test_a_broken_timed_path_is_not_correct(layout, cell, patch):
    line = testing.run(layout, cell, patch=patch)
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())
