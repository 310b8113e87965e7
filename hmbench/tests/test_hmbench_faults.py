"""A run whose timed path is broken underneath comes out not correct: the
cell driven on the CPU at a small size with the harness's look for a card
skipped, once for each fault the cell can have (``hmbench/faults.py``).  No
cell runs on more than one card, so no exchange between cards can be left
out."""
import pytest

from hmbench import faults
from hmbench import run as R


def _correct(ctx) -> bool:
    return R.judge(R.execute(ctx).checks, R.limits(ctx.workload))[0]


def test_sound_run_is_correct(cpu_context, small):
    assert _correct(cpu_context("flagship.offline-b96", **small["flagship.offline-b96"]))


@pytest.mark.parametrize("workload, fault", [
    ("flagship.offline-b96", "doa_turned"),
    ("flagship.offline-b96", "half_batch"),
    ("flagship.stream-open", "doa_turned"),
    ("flagship.stream-open", "state_unchanged"),
])
def test_fault_is_not_correct(cpu_context, small, workload, fault):
    with faults.FAULTS[fault]():
        assert not _correct(cpu_context(workload, **small[workload]))
