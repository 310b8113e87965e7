"""The Monte-Carlo harness of the port (``parallel/montecarlo.py``) and the
utilities it and the benchmark analysis use (``ops/fir.moving_average_full``,
``utils/peak_location``, ``utils/stats``, ``utils/isotonic``) against the
JAX package on the CPU, on the same numpy inputs.

- ``find_peak_location``: exact indices, 4 seeds, periodic and not, the
  port batched over rows against JAX row by row;
- ``moving_average_full``, ``stats.analyze_doa_samples`` /
  ``window_median`` (the one-sided rejection quirk included) and the
  isotonic fits within 1e-12;
- ``folded_angle_error`` and the sweep's ``mae``/``median`` on given
  errors within 1e-6;
- one trial batch of numpy DoAs and noise through both packages' trials
  (the reference peak-window estimator and the matched one) with equal
  DoAs.  The port's own draws come from a ``torch.Generator``; their
  statistics are not held against ``jax.random``'s."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.fir import moving_average_full as jax_moving_average_full
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_signal_from_template
from haghighatshoarmuir2024_tpu.parallel import folded_angle_error as jax_folded_angle_error
from haghighatshoarmuir2024_tpu.parallel import snr_with_bandwidth_correction as jax_snr_bw
from haghighatshoarmuir2024_tpu.utils import isotonic as jax_isotonic
from haghighatshoarmuir2024_tpu.utils import stats as jax_stats
from haghighatshoarmuir2024_tpu.utils.peak_location import find_peak_location as jax_find_peak_location

from haghighatshoarmuir2024_tpu_torch.experiments.target_xylo_localization import peak_window, reference_doa
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.fir import moving_average_full
from haghighatshoarmuir2024_tpu_torch.parallel import (folded_angle_error, make_trial_fn, monte_carlo_sweep,
                                                       snr_with_bandwidth_correction)
from haghighatshoarmuir2024_tpu_torch.utils import isotonic, stats
from haghighatshoarmuir2024_tpu_torch.utils.peak_location import find_peak_location

FS, G, DUR = 48_000, 97, 0.1


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_torch_find_peak_location_matches_jax(seed, periodic):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((6, 113))
    rows[1, :3] += 8.0  # a peak at the start: the shift wraps when periodic
    rows[2, -2:] += 8.0
    for win in (3, 7, 55):
        got = find_peak_location(torch.as_tensor(rows), win, periodic=periodic)
        assert got.shape == (6,)
        ref = [int(jax_find_peak_location(jnp.asarray(r), win, periodic=periodic)) for r in rows]
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(find_peak_location(torch.as_tensor(rows[0]), win, periodic).numpy(), ref[0])
    for bad in (4, 57):  # even; wider than half the row
        with pytest.raises(ValueError):
            find_peak_location(torch.as_tensor(rows), bad)


@pytest.mark.parametrize("win", [1, 3, 8, 31])
def test_torch_moving_average_full_matches_jax(win):
    x = np.random.default_rng(win).standard_normal((3, 64))
    got = moving_average_full(torch.as_tensor(x), win).numpy()
    assert got.shape == (3, 64 + win - 1)
    for row, g in zip(x, got):
        np.testing.assert_allclose(g, np.asarray(jax_moving_average_full(jnp.asarray(row), win)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(g, np.convolve(np.ones(win), row, mode="full"), rtol=0, atol=1e-12)


@pytest.mark.parametrize("reject_jump", [5.0, 20.0])
@pytest.mark.parametrize("seed", range(3))
def test_torch_stats_match_jax(seed, reject_jump):
    rng = np.random.default_rng(seed)
    data = 30 + 4 * rng.standard_normal(200)
    data[rng.integers(0, 200, 12)] += 40  # jumps above the median: rejected
    data[rng.integers(0, 200, 12)] -= 40  # jumps below: kept (the reference's one-sided quirk)
    got = stats.analyze_doa_samples(data, window_length=25, reject_jump=reject_jump)
    ref = jax_stats.analyze_doa_samples(data, window_length=25, reject_jump=reject_jump)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(stats.window_median(data, 9, reject_jump), jax_stats.window_median(data, 9, reject_jump),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(stats.make_window(data, 7), jax_stats.make_window(data, 7))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_torch_isotonic_matches_jax(seed, weighted):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.standard_normal(40)) + 3 * rng.standard_normal(40)
    w = rng.uniform(0.5, 2.0, 40) if weighted else None
    for name in ("isotonic_increasing", "approx_decreasing"):
        got = getattr(isotonic, name)(y, w)
        np.testing.assert_allclose(got, getattr(jax_isotonic, name)(y, w), rtol=1e-12, atol=1e-12, err_msg=name)
    assert np.all(np.diff(isotonic.isotonic_increasing(y, w)) >= 0)
    assert isotonic.isotonic_increasing(np.zeros(0)).shape == (0,)


def test_torch_folded_error_and_sweep_statistics_match_jax():
    rng = np.random.default_rng(5)
    true = rng.uniform(0, 2 * np.pi, (3, 50))
    est = true + rng.normal(0, 0.4, (3, 50)) + np.pi * (rng.random((3, 50)) < 0.2)
    ref = np.asarray(jax_folded_angle_error(jnp.asarray(est), jnp.asarray(true)))
    np.testing.assert_allclose(folded_angle_error(torch.as_tensor(est), torch.as_tensor(true)).numpy(), ref,
                               rtol=0, atol=1e-6)
    flat_true, flat_est = iter(true.reshape(-1)), iter(est.reshape(-1))

    def trial(gen, snr_db, n):  # the given DoAs, SNR row by SNR row, n at a time
        return (torch.as_tensor([next(flat_true) for _ in range(n)]),
                torch.as_tensor([next(flat_est) for _ in range(n)]))

    trial.device = torch.device("cpu")
    out = monte_carlo_sweep(trial, [-10.0, 0.0, 10.0], 50, batch_size=20)
    assert sorted(out) == ["errors", "mae", "median", "snr_db"]
    np.testing.assert_allclose(out["errors"], ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["mae"], ref.mean(axis=1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["median"], np.median(ref, axis=1), rtol=0, atol=1e-6)
    for snr in (-10.0, 0.0, 17.5):
        np.testing.assert_allclose(snr_with_bandwidth_correction(snr, FS, (1000, 2000)),
                                   jax_snr_bw(snr, FS, (1000, 2000)), rtol=1e-12)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A bipolar 1000-2000 Hz model (the harness's band) designed and
    calibrated by JAX, loaded by the port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=[[1000, 2000]],
                     doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=DUR, kernel_duration=5e-3,
                     bipolar_spikes=True, fs=FS, use_cache=False)
        t = np.arange(0, DUR, 1 / FS)
        sig = np.sin(2 * np.pi * 1500 * t)
        jd.calibrate_profiles(template=(t, sig), use_cache=False)
    path = tmp_path_factory.mktemp("mc") / "model.npz"
    jd.save(str(path))
    return jd, Demo.load(str(path), device="cpu"), t, sig


def jax_trial_batch(jd, t, sig, doas, noise, snr_db, estimate):
    """JAX ``make_trial_fn``'s trial body (``montecarlo.py:60-70``) with the
    DoA and the noise given instead of drawn."""
    t32, s32 = jnp.asarray(t, jnp.float32), jnp.asarray(sig, jnp.float32)
    out = []
    for d, z in zip(doas, noise):
        s = jax_signal_from_template(jd.geometry, t32, s32, jnp.float32(d), fs=FS)
        sigma = jnp.sqrt(jnp.mean(s**2) / jnp.float32(10.0 ** (snr_db / 10.0)))
        out.append(float(estimate(s + sigma * jnp.asarray(z))))
    return np.asarray(out)


@pytest.mark.parametrize("snr_db", [-5.0, 10.0])
def test_torch_trial_batch_matches_jax(models, snr_db):
    jd, td, t, sig = models
    rng = np.random.default_rng(int(snr_db) + 20)
    doas = rng.uniform(0, 2 * np.pi, 6).astype(np.float32)
    noise = rng.standard_normal((6, len(t), 7)).astype(np.float32)
    grid = jnp.asarray(jd.doa_list)
    win = peak_window(G)
    assert win == 3

    def jax_reference(s):
        _, rate = jd._forward_jit(s)
        return grid[jax_find_peak_location(rate, win)]

    def jax_matched(s):
        return jd._forward_matched_jit(s)[0]

    estimators = {
        "reference": (lambda f: reference_doa(td, td.fold(td.rates_batch(f))), jax_reference),
        "matched": (lambda f: td.forward_batch(f, method="matched")[0], jax_matched),
    }
    for name, (port_est, jax_est) in estimators.items():
        trial = make_trial_fn(td.geometry, t, sig, port_est, FS, device="cpu")
        true, est = trial(None, snr_db, 6, doa_true=doas, noise=noise)
        np.testing.assert_array_equal(true.numpy(), doas)
        ref = jax_trial_batch(jd, t, sig, doas, noise, snr_db, jax_est)
        idx = lambda d: np.abs(np.asarray(d)[:, None] - jd.doa_list[None, :]).argmin(axis=1) % (G - 1)  # noqa: E731
        np.testing.assert_array_equal(idx(est.numpy()), idx(ref), err_msg=name)


def test_torch_sweep_replays_its_draws_for_every_snr(models):
    """The generator is seeded anew for each SNR (JAX reuses its keys), and
    the batch size does not change a trial's draws when it divides the
    trials."""
    _, td, t, sig = models
    seen = []

    def estimate(frames):
        seen.append(frames.shape[0])
        return torch.zeros(frames.shape[0])

    trial = make_trial_fn(td.geometry, t, sig, estimate, FS, device="cpu")
    a = monte_carlo_sweep(trial, [-10.0, 20.0], 6, seed=3)
    b = monte_carlo_sweep(trial, [-10.0, 20.0], 6, seed=3, batch_size=6)
    np.testing.assert_array_equal(a["errors"][0], a["errors"][1])
    np.testing.assert_array_equal(a["errors"], b["errors"])
    c = monte_carlo_sweep(trial, [0.0], 6, seed=4, batch_size=4)
    assert seen[-2:] == [4, 2] and c["errors"].shape == (1, 6)
    assert not np.array_equal(c["errors"][0], a["errors"][0])
