"""``experiments/hand_kernels.py`` on the CPU: the dump of the two hand
kernels' inputs and outputs and its comparison across two dumps, the
kernel-name parsing of a trace, the band-stacked width diagnostic's
plumbing, and the card-only modes' refusal without a card.  (On CPU tensors
the wrappers run their plain versions, so a dump here holds those.)"""
import numpy as np
import pytest
import torch

import chip_smoke
from haghighatshoarmuir2024_tpu_torch.experiments import hand_kernels as hk
from haghighatshoarmuir2024_tpu_torch.ops import iir
from haghighatshoarmuir2024_tpu_torch.ops.cuda import matched_kernel


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    sig = torch.as_tensor(rng.standard_normal((480, 3, 14)).astype(np.float32))
    rate = torch.as_tensor((rng.random((5, 17)) * 100).astype(np.float32))
    table = torch.as_tensor(rng.standard_normal((17, 17)).astype(np.float32))
    return None, sig, iir.butter_bandpass(1, (1600.0, 1900.0), 48_000.0), rate, table


def test_dump_and_compare_on_the_cpu(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    arrays = hk.dump(str(a), "cpu", inputs=_inputs())
    hk.dump(str(b), "cpu", inputs=_inputs())
    # the flagship's input and every case of chip_smoke.py phase 27, with their outputs and carried states
    assert len([k for k in arrays if k.startswith("iir/") and k.endswith("/out")]) == 1 + len(hk.IIR_PLAIN_CASES)
    assert sum(c[3] for c in hk.IIR_PLAIN_CASES) == len([k for k in arrays if k.endswith("/state")])
    res = hk.compare(str(a), str(b))
    assert res and all(r["differ"] == 0 and r["bits_differ"] == 0 for r in res.values())
    assert arrays["matched/scores"].shape == (5, 17)
    np.testing.assert_array_equal(arrays["matched/scores"],
                                  matched_kernel.matched_scores_plain(*_inputs()[3:]).numpy())


def test_compare_counts_outputs_and_refuses_other_inputs(tmp_path):
    a, b, c = tmp_path / "a.npz", tmp_path / "b.npz", tmp_path / "c.npz"
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = x * 2
    np.savez(a, **{"iir/x/in": x, "iir/x/out": out})
    moved = out.copy()
    moved[1, 2] += 1.0
    moved[0, 0] = -0.0  # equal in value, not in bits
    np.savez(b, **{"iir/x/in": x, "iir/x/out": moved})
    r = hk.compare(str(a), str(b))["iir/x/out"]
    assert (r["differ"], r["bits_differ"], r["max_abs_diff"]) == (1, 2, 1.0)
    np.savez(c, **{"iir/x/in": x + 1, "iir/x/out": out})
    with pytest.raises(ValueError, match="not of the same inputs"):
        hk.compare(str(a), str(c))


def test_cases_are_chip_smokes():
    assert hk.IIR_PLAIN_CASES == chip_smoke.IIR_PLAIN_CASES
    assert hk.WIDTHS == chip_smoke.WIDTHS


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::superblock_kernel<32, 4>((anonymous namespace)::SuperBlock)", "superblock_kernel"),
    ("void (anonymous namespace)::assemble_kernel<32, 4>((anonymous namespace)::Assembly)", "assemble_kernel"),
    ("void (anonymous namespace)::matched_kernel<8>(float const*, float const*, float*, int, int, int, int)",
     "matched_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, at::detail::Array<char*, 1> >"
     "(int, at::native::FillFunctor<float>, at::detail::Array<char*, 1>)", "vectorized_elementwise_kernel"),
])
def test_short_kernel_names(name, short):
    assert hk.short_name(name) == short


def test_device_ms_counts_whole_launches():
    """A record CUPTI dropped at the edge of the window does not lower a
    call's device time: launches a call are rounded to whole ones."""
    traced = {"superblock_kernel": [0.05] * 19, "assemble_kernel": [0.07] * 20, "twice": [0.01] * 40}
    assert [hk.launches_a_call(v, 20) for v in traced.values()] == [1, 1, 2]
    assert hk.device_ms(traced, 20) == pytest.approx(0.05 + 0.07 + 2 * 0.01)


class _RowWise:
    """Scores that are a function of each row alone, and one whose rounding
    follows the batch: the diagnostic must tell them apart."""

    def __init__(self, by_width: bool = False):
        self.by_width = by_width

    def rates_batch(self, frames):
        return frames

    def doa_scores(self, rate, method):
        s = rate * 3.0 + 1.0
        return s + (1e-3 * rate.shape[0] if self.by_width else 0.0)

    def estimate_doa_from_rate(self, rate, method):
        return torch.argmax(self.doa_scores(rate, method), dim=-1)


def test_stacked_width_counts_what_moves():
    frames = torch.as_tensor(np.random.default_rng(3).standard_normal((12, 9)).astype(np.float32))
    same = hk.stacked_width(_RowWise(), frames, (1, 4, 7))
    assert set(same) == set(hk.STACKED) and all(d == (0, 0) for r in same.values() for d in r.values())
    moved = hk.stacked_width(_RowWise(by_width=True), frames, (1, 4, 7))
    assert all(r[w][0] == w * 9 for r in moved.values() for w in (1, 4, 7))


def test_card_modes_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (hk.split, hk.stacked):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hk.dump("unused.npz")


G3, F3 = 17, 3


def _stacked_demo(seed=0, scale=None):
    """A Demo with only what the band-stacked scoring reads: its grid, a
    (G, F·G) band-stacked table and rates that are the frames themselves."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

    rng = np.random.default_rng(seed)
    demo = Demo.__new__(Demo)
    demo.device = torch.device("cpu")
    demo.doa_list = np.linspace(-np.pi, np.pi, G3)
    demo._profiles_t = None
    demo._set_profiles_stacked((rng.random((G3, F3 * G3)) * 50 + 5).astype(np.float32))
    demo.rates_batch = lambda frames: frames
    rate = torch.as_tensor((rng.random((6, F3 * G3)) * 100).astype(np.float32))
    if scale is not None:
        inner = demo.doa_scores
        demo.doa_scores = lambda r, m: inner(r, m) * scale
    return demo, rate


@pytest.mark.parametrize("method", hk.STACKED)
def test_stacked_tolerance_covers_the_float32_route(method):
    """The bound the card's band-stacked scores are held to covers the
    float32 CPU route's distance from the same route in float64."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo.pipeline import _auto_blend_scores, _blockcos

    demo, rate = _stacked_demo(1)
    got = demo.doa_scores(rate, method).double()
    table64 = demo._stacked_t.double()
    if method == "matched_stacked":
        ref = _blockcos(rate.double(), G3) @ _blockcos(table64, G3).T
    else:
        ref = _auto_blend_scores(rate.double(), table64, G3)
    tol = hk.stacked_tolerance(rate, demo._stacked_t, demo._stacked_cos_t, G3, method)
    assert tol.shape == got.shape and bool((tol > 0).all())
    assert bool(((got - ref).abs() <= tol).all())
    with pytest.raises(ValueError, match="band-stacked"):
        hk.stacked_tolerance(rate, demo._stacked_t, demo._stacked_cos_t, G3, "matched")


def test_stacked_checks_on_the_cpu_and_what_they_catch(monkeypatch):
    """On the CPU both sides of phase 27's band-stacked checks are the plain
    route, so nothing differs; a route off by one part in a thousand is far
    outside the bound."""
    demo, rate = _stacked_demo(2)
    parts = hk.stacked_parts_against_plain(demo, rate)
    assert sorted(parts) == sorted(["matched_scores(center=False) K=51", "band_scores K=17", "row_sums K=3",
                                    "row_sums K=4", "row_sums K=17"])
    assert all(p == (0.0, 0.0) for p in parts.values())
    same = hk.stacked_against_cpu(demo, rate)
    assert set(same) == set(hk.STACKED)
    assert all(r == dict(of_bound=0.0, max_abs_err=0.0, doas_differ=0, doas_differ_at_ties=0) for r in same.values())
    monkeypatch.setattr(hk, "cpu_route", lambda _: demo)  # the CPU side stays the plain route
    off = hk.stacked_against_cpu(*_stacked_demo(2, scale=1.001))
    assert all(r["of_bound"] > 1.0 for r in off.values())


def test_of_bound_is_the_fraction_of_the_sum_bound():
    got, ref = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 2.0 + 2e-6, 3.0])
    worst, max_abs = hk.of_bound(got, ref, torch.tensor([1.0, 1.0, 0.0]), 4)
    assert worst == pytest.approx(abs(float(np.float32(2.0 + 2e-6)) - 2.0) / (8 * hk.EPS32))
    assert max_abs == pytest.approx(abs(float(np.float32(2.0 + 2e-6)) - 2.0))
