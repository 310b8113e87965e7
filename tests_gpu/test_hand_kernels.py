"""The two hand kernels with no TPU kernel behind them, ``iir_lifted``
(``csrc/iir_lifted.cu``) and ``matched`` (``csrc/matched.cu``), on the card
at the flagship's and the streaming path's shapes:

  * against their plain versions, within 3 sqrt(T) eps_f32 of each column's
    largest value (the IIR) and the dot products' bound 2 K eps sum |r t|
    (the scores), at level 2 and level 1, carried and not;
  * across widths, bit for bit: a stream's columns or a frame's scores alone
    equal the same ones in a wider call;
  * the band-stacked estimators, scored by the same kernel without the
    centring, across widths bit for bit.

The checks are ``chip_smoke.py`` phase 26-27 functions, so every run of that
script makes them too.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda
WIDTHS = (1, 4, 7, 12, 24, 48)


@pytest.fixture(scope="module")
def flagship():
    """The flagship demo (bundled design and table) and its 96 frames."""
    if not torch.cuda.is_available():
        pytest.skip("tests_gpu needs a CUDA device (torch.cuda.is_available() is false)")
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import flagship_config, flagship_frames

    demo = Demo(**flagship_config(torch.device("cuda", 0)))
    demo.calibrate_profiles()
    frames, _ = flagship_frames(demo, 96, seed=cs.SEED)
    return demo, frames


def test_iir_lifted_flagship_against_plain_and_across_widths(flagship):
    """The encode input of ``forward_batch`` (T = 12 000, 96 x 14 columns):
    one launch of the wrapper, within the bound of the plain version, and
    the first w streams' columns with a carried state alone = the same
    columns of all 96, bit for bit."""
    from haghighatshoarmuir2024_tpu_torch.ops import iir
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build

    demo, frames = flagship
    sig = cs.flagship_encode_input(torch, demo, frames)
    T, B, C = sig.shape
    b, a = demo.filterbank.ba_list[0]
    _build.launch_counts.clear()
    iir.iir_cumsum_blocked(b, a, sig)
    assert _build.launch_counts["iir_lifted"] == 1
    err, _ = cs.iir_against_plain(torch, b, a, sig, None, iir.SB)
    assert err <= cs.iir_bound(T)
    zi = torch.as_tensor(np.random.default_rng(7).standard_normal((B * C, 3)).astype(np.float32), device=sig.device)
    bits = cs.iir_width_bits(torch, b, a, sig.reshape(T, -1), zi, C, WIDTHS)
    assert not any(bits.values()), bits


@pytest.mark.parametrize("T,L,sb,carried", cs.IIR_PLAIN_CASES,
                         ids=[f"T{c[0]}-L{c[1]}-sb{c[2]}{'-carried' if c[3] else ''}" for c in cs.IIR_PLAIN_CASES])
def test_iir_lifted_paths_against_plain_and_across_widths(T, L, sb, carried):
    """Level 1 (nb = 2; the prime nb = 257), a ragged T and the streaming
    block sizes with a carried state: within the bound of the plain version,
    and the first half of the columns alone = the same columns of the whole
    call, bit for bit."""
    from haghighatshoarmuir2024_tpu_torch.ops import iir

    dev = torch.device("cuda", 0)
    b, a = iir.butter_bandpass(1, (1600.0, 1900.0), 48_000.0)
    rng = np.random.default_rng(T + L + sb)
    x = torch.as_tensor(rng.standard_normal((T, L)).astype(np.float32), device=dev)
    zi = torch.as_tensor(rng.standard_normal((L, 3)).astype(np.float32), device=dev)
    err, _ = cs.iir_against_plain(torch, b, a, x, zi if carried else None, sb)
    assert err <= cs.iir_bound(T)
    if T % sb == 0:
        bits = cs.iir_width_bits(torch, b, a, x, zi, L // 2, (1,), sb=sb)
        assert not any(bits.values()), bits


def test_matched_flagship_against_plain_and_across_widths(flagship):
    """The flagship's (96, 449) rates against the 449 x 449 table: within
    the bound of the plain version, centred and not, and the scores of the
    first w frames alone = the same frames' among 96, bit for bit."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, matched_kernel

    demo, frames = flagship
    rate = demo.fold(demo.rates_batch(frames))
    table = demo._profiles_t
    assert _build.library().hm_matched_max_k() == matched_kernel.K_MAX
    for center in (True, False):
        worst, _ = cs.matched_against_plain(torch, rate, table, center)
        assert worst <= 1.0, (center, worst)
        bits = cs.matched_width_bits(torch, rate, table, cs.SCORE_WIDTHS, center)
        assert not any(bits.values()), (center, bits)


@pytest.mark.parametrize("B,K,G", [(96, 1347, 449), (9, 8000, 40), (3, 12_000, 5)],
                         ids=["three-band-unfolded", "four-frame-tiles", "longest-rows"])
def test_matched_wide_rows_against_plain_and_across_widths(B, K, G):
    """Rows of the three-band model's unfolded width, and rows long enough
    that a block holds four frames (K > 7168) up to the longest the kernel
    takes; one entry more raises ``ValueError``."""
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import matched_kernel

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(B + K)
    rate = torch.as_tensor((rng.random((B, K)) * 300).astype(np.float32), device=dev)
    table = torch.as_tensor(rng.standard_normal((G, K)).astype(np.float32), device=dev)
    worst, _ = cs.matched_against_plain(torch, rate, table)
    assert worst <= 1.0
    bits = cs.matched_width_bits(torch, rate, table, [w for w in (1, 2, 5, 7) if w < B])
    assert not any(bits.values()), bits
    if K == matched_kernel.K_MAX:
        wide = torch.zeros((1, K + 1), device=dev)
        with pytest.raises(ValueError):
            matched_kernel.matched_scores(wide, torch.zeros((G, K + 1), device=dev))


@pytest.fixture(scope="module")
def two_band():
    """A two-band model calibrated band-stacked on the card, and 24 frames."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.multiband import multiband_frames, wideband_template
    from haghighatshoarmuir2024_tpu_torch.geometry import CenterCircularArray

    if not torch.cuda.is_available():
        pytest.skip("tests_gpu needs a CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    demo = Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1600, 2000], [2000, 2300]],
                doa_list=np.linspace(-np.pi, np.pi, 65), recording_duration=0.25, kernel_duration=10e-3,
                bipolar_spikes=True, fs=48_000, enforce_hw_limits=False, device=dev, use_cache=False)
    frames, _, _ = multiband_frames(demo, 24, seed=cs.SEED)
    demo.calibrate_profiles(template=wideband_template(48_000), use_cache=False, band_stacked=True)
    return demo, frames


def test_stacked_estimators_across_widths(two_band):
    """``matched_stacked`` and ``matched_auto`` of the two-band model: the
    scores and DoAs of the first w frames alone = the same frames' among
    all, bit for bit (``experiments/hand_kernels.stacked_width``; phase 26
    runs the three-band model)."""
    from haghighatshoarmuir2024_tpu_torch.experiments.hand_kernels import stacked_width

    got = stacked_width(*two_band, (1, 4, 7, 12))
    assert not any(any(d) for r in got.values() for d in r.values()), got


def test_stacked_routes_against_plain_and_the_cpu_route(two_band):
    """The band-stacked estimators' routes through the matched kernel
    (``matched_scores(center=False)``, ``band_scores``, ``row_sums``) within
    2 K eps sum |r t| of their plain versions on the same card tensors, and
    their scores within ``stacked_tolerance`` of the CPU route's, DoAs equal
    but at a tie (phase 27 runs the three-band model)."""
    from haghighatshoarmuir2024_tpu_torch.experiments import hand_kernels as hk

    parts = hk.stacked_parts_against_plain(*two_band)
    assert len(parts) == 5 and all(worst <= 1.0 for worst, _ in parts.values()), parts
    scores = hk.stacked_against_cpu(*two_band)
    assert all(r["of_bound"] <= 1.0 and r["doas_differ"] == r["doas_differ_at_ties"] for r in scores.values()), scores
