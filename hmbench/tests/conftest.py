"""The benchmark's own tests, on the CPU at small sizes:

    python -m pytest hmbench/tests -q

A cell is driven here through the port's CPU path (its kernels' plain
versions) with a few frames or streams in place of the cell's own; the
control's and the cell's readings at full size are taken on the card
(``python3 -m hmbench.control``, ``python3 -m hmbench.run``)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cpu_context():
    """A cell's context on the CPU, its traffic cut by ``overrides``."""
    import torch

    from hmbench.run import make_context

    def make(workload, seed=5, seconds=0.05, trace=False, **overrides):
        ctx = make_context(workload, seed, seconds, trace)
        ctx.devices = [torch.device("cpu")] * int(ctx.cell["chips"])
        ctx.traffic.update(overrides)
        return ctx

    return make


SMALL = {
    "flagship.offline-b96": dict(batch=2, pool_batches=2),
    "threeband.offline-b96": dict(batch=2, pool_batches=1),
    "flagship.stream-open": dict(lanes=2, groups=2, pool_groups=2, check_groups=1, check_steps=2, steps_before_window=1),
}


@pytest.fixture
def small():
    return SMALL
