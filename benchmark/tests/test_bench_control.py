"""The control on the card: each cell with the program's own lower
precision switched on (the turbo int8 routes) has to come out not correct
at the cell's own size. Marked `cuda`; skips without a card."""
from __future__ import annotations

import pytest

from benchmark.harness import load_spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the cell at its own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in load_spec()["workloads"]])
def test_control_is_not_correct(card, workload):
    from benchmark.control import one
    r = one(workload, 2 ** 31 + 101, 3.0)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert not r["correct"], r["checks"]
