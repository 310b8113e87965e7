"""The yardstick's counts reproduce the port's PERF.md figures at the
flagship (B = 96, T = 12 000, C = 14, N = 449)."""
import pytest

from hmbench import roofline


def test_k3_operations():
    ops, _ = roofline.lif_work(1_172_279, 12_000, 96, 449, 28)
    assert ops == pytest.approx(5.699e9, rel=1e-3)


def test_iir_lifted_bytes():
    assert roofline.iir_lifted_work(12_000, 96, 14)[1] == pytest.approx(1.291e8, rel=1e-3)


def test_pack_and_rzcc_bytes():
    assert roofline.pack_work(12_000, 96, 14)[1] == pytest.approx(3.686e7, rel=1e-3)
    assert roofline.k1_work(12_000, 96 * 14)[1] == pytest.approx(1.29e8, rel=1e-2)
    assert roofline.k2_work(12_000, 96 * 14)[1] == pytest.approx(6.451e7, rel=1e-3)


def test_step_bound_is_the_sum_of_its_kernels():
    shape = dict(T=12_000, B=96, M=7, F=1, C=14, N=449, G=449, K=480)
    b = roofline.step_bound_s(shape, 1_172_279)
    assert b["lif"] == pytest.approx(5.699e9 / roofline.PEAKS["int32_ops_per_s"], rel=1e-3)
    assert 0.3e-3 < sum(b.values()) < 0.5e-3
